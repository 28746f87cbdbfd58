"""The example drivers of the port (the twins of the JAX package's
``examples/``), each runnable as ``python -m
elemental_tpu_torch.examples.<name>`` or as a file, on ``cuda:0`` unless
``--device cpu``; ``_common.EXAMPLES`` lists them.  They double as a
smoke suite: each prints one ``[name] k=v`` line of residuals."""
