"""Time builds of ``lu_panel.cu`` from several source directories against
each other, on one card, in one process.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 -m elemental_tpu_torch.kernels.ab_timing DIR [DIR ...] \
        [--unchecked DIR ...]

Each DIR holds a ``lu_panel.cu`` and the headers it includes (missing
headers are taken from ``csrc/``): the committed source, an earlier
revision from git history, or a copy with one change to try.  Every
source is built with the port's ``nvcc`` flags into
``kernels/build/ab_timing/`` (ignored by git), one ``nvcc`` per source,
all at once.  At three float32 panels (32768, 8192 and 2048 rows, 2048
columns, ``inner`` = 64) the builds are timed with CUDA events in turns,
first to last then last to first, so that drift on the card falls on
every build alike, and each build's pivots are held against the plain
version's (a build named in ``--unchecked`` is timed only: a change
that drops part of the arithmetic to see what it costs).  One JSON line
per panel gives the mean time of each turn per build, in ms, and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

PANELS = ((32768, 2048), (8192, 2048), (2048, 2048))
INNER = 64
REPS = 5


def _build(dirs) -> list:
    from . import common
    out = common.BUILD_DIR / "ab_timing"
    procs = []
    for i, d in enumerate(dirs):
        work = out / str(i)
        work.mkdir(parents=True, exist_ok=True)
        for src in list(common.CSRC.glob("*.cuh")) + list(d.glob("*.cuh")):
            shutil.copy(src, work / src.name)
        shutil.copy(d / "lu_panel.cu", work / "lu_panel.cu")
        lib = work / "liblu_panel.so"
        procs.append((subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib),
             str(work / "lu_panel.cu")]), lib))
    libs = []
    for proc, lib in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"ab_timing: the build of {lib} failed")
        libs.append(ctypes.CDLL(str(lib)))
    for lib in libs:
        for f in (lib.lu_panel_scratch, lib.lu_panel_words):
            f.argtypes = [ctypes.c_int] * 2
            f.restype = ctypes.c_longlong
        lib.lu_panel_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]
        lib.lu_panel_f32.restype = ctypes.c_int
    return libs


def _factor(lib, P, nbw, gmax):
    """One call of a build, as the wrapper makes it (clone, scratch)."""
    import torch
    M = P.shape[0]
    out = P.clone()
    perm = torch.empty(M, dtype=torch.int64, device=P.device)
    ws = torch.empty(lib.lu_panel_scratch(nbw, gmax), device=P.device)
    wz = torch.zeros(lib.lu_panel_words(nbw, gmax), dtype=torch.int64,
                     device=P.device)
    err = lib.lu_panel_f32(out.data_ptr(), nbw, M, nbw, INNER,
                           perm.data_ptr(), ws.data_ptr(), wz.data_ptr(),
                           gmax, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ab_timing: CUDA error {err}")
    return out, perm


def _time_ms(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None) -> int:
    import torch
    from .lu_panel import lu_panel_reference
    ap = argparse.ArgumentParser(prog="ab_timing")
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--unchecked", nargs="*", type=Path, default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_timing: no CUDA device", file=sys.stderr)
        return 1
    dirs = list(args.dirs)
    libs = _build(dirs)
    unchecked = {d.resolve() for d in args.unchecked}
    gmax = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    order = list(range(len(dirs))) + list(reversed(range(len(dirs))))
    for M, nbw in PANELS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(M + nbw)
        P = torch.randn(M, nbw, generator=gen, device="cuda")
        _, rperm = lu_panel_reference(P, nbw, INNER)
        ms = {str(d): [] for d in dirs}
        for i in order:
            if dirs[i].resolve() not in unchecked:
                _, perm = _factor(libs[i], P, nbw, gmax)
                if not torch.equal(perm, rperm):
                    raise AssertionError(f"ab_timing: {dirs[i]} gives other "
                                         f"pivots than the plain version")
            ms[str(dirs[i])].append(
                _time_ms(lambda: _factor(libs[i], P, nbw, gmax)))
        print(json.dumps({"panel": [M, nbw], "inner": INNER, "ms": ms,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
