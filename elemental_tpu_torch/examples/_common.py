"""Shared example scaffolding: device / grid set-up and reporting.

The twin of the JAX package's ``examples/_common.py`` (the boilerplate
every upstream driver repeats: ``El::Initialize`` + ``El::Input`` + grid
construction).  Where the JAX examples build their grid from
``jax.devices()``, the twins build a virtual grid of ``--ranks`` ranks on
one device, as ``entry.dryrun_multichip`` does: ``--ranks`` stands in for
the device count, ``--grid-height`` picks the height (0 = near-square,
as JAX).  Every example runs on ``cuda:0`` unless ``--device cpu``::

    python -m elemental_tpu_torch.examples.cholesky --n 4096
    python -m elemental_tpu_torch.examples.cholesky --n 96 --device cpu --ranks 8

Without a card and without ``--device cpu`` an example exits 2.  The
examples compute in float64, as the JAX ones; their checks run on the
grid's device in float64 (a host copy of a 32768 x 32768 Q would take the
host minutes to multiply), and only scalars reach the host.
"""
from __future__ import annotations

import sys

#: example modules, in the order the JAX test lists them
EXAMPLES = ("cholesky", "lu", "qr_least_squares", "herm_eig", "svd", "lp",
            "lav", "rpca", "pseudospectra", "spd_scaling_sweep")


def setup(argv=None):
    """``(el, args, grid)``: the package, the parsed ``el.Args`` (the
    example registers its own flags on it, then calls ``process``) and an
    r x c virtual grid of ``--ranks`` ranks on ``--device``."""
    import torch
    import elemental_tpu_torch as el
    from elemental_tpu_torch.entry import _near_square_height
    args = el.Args(sys.argv[1:] if argv is None else argv)
    height = args.input("--grid-height", "grid height (0 = near-square)", 0)
    device = args.input("--device", "device of the grid", "cuda")
    ranks = args.input("--ranks", "virtual ranks (0 = the card count; 1 "
                       "on the CPU)", 0)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            print("examples: no CUDA device; pass --device cpu",
                  file=sys.stderr)
            raise SystemExit(2)
        # full float32 matmuls: the drivers refuse TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
    p = ranks or (torch.cuda.device_count() if on_card else 1)
    r = height or _near_square_height(p)
    if p % r:
        raise ValueError(f"grid height {r} does not divide device count {p}")
    return el, args, el.Grid(r, p // r, device=device)


def report(name: str, **metrics) -> dict:
    """Print ``[name] k=v ...`` (floats as ``%.3e``) and return the
    metrics."""
    parts = " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in metrics.items())
    print(f"[{name}] {parts}", flush=True)
    return metrics


def parse_reports(text: str) -> list:
    """``[(name, {key: value-string})]`` of the ``[name] k=v`` lines in
    ``text``, in order."""
    out = []
    for line in text.splitlines():
        if not line.startswith("[") or "] " not in line:
            continue
        name, rest = line[1:].split("] ", 1)
        out.append((name, dict(kv.split("=", 1) for kv in rest.split()
                               if "=" in kv)))
    return out


def rel_norm(X, F) -> float:
    """``||X|| / ||F||`` (Frobenius) as a Python float."""
    import torch
    return float(torch.linalg.norm(X) / torch.linalg.norm(F))
