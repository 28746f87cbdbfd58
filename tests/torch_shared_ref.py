"""A memo of the JAX package's reference results, shared by the pytest-xdist
workers of one run.

Many port tests hold the port, on several grids, against one result of the
JAX package computed on a 1x1 grid.  ``functools.cache`` keeps that result
for one process only, so each worker that draws one of those cases computed
it again; several of these references are host-driven loops that ``jax.jit``
cannot trace and take tens of seconds.  :func:`shared_cache` is
``functools.cache`` that also keeps a pickled copy per run: the first worker
to ask computes it while it holds a lock on the entry, the others wait for
it and read it.  Outside xdist it is ``functools.cache``.  A result that
does not pickle is computed in every worker, as before.
"""
import fcntl
import functools
import hashlib
import os
import pickle
import tempfile
from pathlib import Path

import torch

# The port's test inputs are small: one intra-op thread per test process.
# Under pytest-xdist each worker otherwise starts as many threads as the
# machine has cores, and the workers' threads contend for the same cores.
torch.set_num_threads(1)


def _run_dir():
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not uid:
        return None
    d = Path(tempfile.gettempdir()) / f"elemental_tpu_torch_refs_{uid}"
    d.mkdir(exist_ok=True)
    return d


def shared_cache(fn):
    """``functools.cache`` of ``fn``, shared across the xdist workers of one
    run through a pickle per call, keyed by ``fn``'s name and the repr of
    its arguments."""
    @functools.cache
    def wrapper(*args, **kw):
        d = _run_dir()
        if d is None:
            return fn(*args, **kw)
        key = hashlib.sha256(repr((fn.__module__, fn.__qualname__, args,
                                   sorted(kw.items()))).encode()).hexdigest()
        path = d / f"{key[:32]}.pkl"
        with open(d / f"{key[:32]}.lock", "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if path.exists():
                    return pickle.loads(path.read_bytes())
                out = fn(*args, **kw)
                try:
                    data = pickle.dumps(out)
                except Exception:
                    return out
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                tmp.write_bytes(data)
                tmp.replace(path)
                return out
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    return wrapper
