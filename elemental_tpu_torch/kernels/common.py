"""Shared plumbing of the port's hand-written Hopper kernels: the build
and load of the CUDA sources.

No size gate.  The JAX package's ``panel_fits`` caps a Pallas block at
its 16 MiB VMEM budget (w <= 1024 at f32 for ``potrf_inv``), because a
Pallas panel kernel keeps its whole block resident in the TPU core's
VMEM.  The port's ``potrf_inv`` keeps on chip only a 32 x 32 diagonal
block and one product tile's operands per thread block, and works in
place in its outputs in device memory, so it has no size limit and no
gate: every real block on a CUDA tensor launches it, and a block too
large for device memory fails its allocation and raises (the plain
version would need as much).  ``lu_panel`` likewise keeps its panel in
device memory and stages each thread block's slab of the current
(at most 64-column) inner chunk in shared memory when it fits, beyond
~117k rows in float and ~58k in double working on it in place; its
scratch (published rows, the <= 2 x 128 rows an outer block displaces,
a pivot key per column) grows with the panel width only, so it has no
size gate either; nor has ``qr_panel``, built the same way (its
scratch, the partial sums of at most 64 row slices of a 128 x k
product, grows with the panel width only).

The build.  Each ``csrc/*.cu`` source is compiled by hand with ``nvcc``
into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  A build
happens at first use, into ``kernels/build/`` (ignored by git), under a
name keyed by the hash of the source and the shared ``csrc/*.cuh``
headers, so an edited source is never served from a stale library.
:func:`build` starts one ``nvcc`` per source, all at once.  Nothing is
imported or compiled when this module is imported, and a failed build
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path


CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

#: ``nvcc`` flags: Hopper with its architecture-specific features (sm_90a)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                       + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):      # shared headers
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names) -> dict:
    """Compile the named ``csrc/<name>.cu`` sources that are not built
    yet, one ``nvcc`` process per source, all started together; return
    ``{name: path of the .so}``.  Raises with the compiler's output if
    any build fails."""
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    errors = []
    for n, (proc, tmp, p) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, p)           # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library (built at first use) with the
    ``argtypes``/``restype`` of ``signatures`` = {fn: (argtypes, restype)}
    declared."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (argtypes, restype) in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = restype
        _LIBS[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
