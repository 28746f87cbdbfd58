"""Where one step of a panel kernel's spine spends its time, on the card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 -m elemental_tpu_torch.kernels.spine_probe [qr|lu|potrf] [--src DIR]

The committed kernels have no probe switch.  This script copies the
kernel's source (``csrc/qr_panel.cu``, ``csrc/lu_panel.cu`` or
``csrc/potrf_inv.cu``; with ``--src``, the one in DIR and the headers
beside it, such as an earlier revision taken from git history) and its
headers into ``kernels/build/spine_probe/`` (ignored by git), inserts
``%globaltimer`` stamps into the copy's loop, builds it with the port's
``nvcc`` flags, runs it and prints, as one JSON line, the mean time a
step spends between consecutive stamps.

``qr`` and ``lu`` follow one column of the column loop (thread 0 of
thread block 0, one inner chunk in the middle of the panel) while a
float32 and then a float64 panel are factored (QR: 65536 x 2048 and the
``qr_least_squares`` example's 32768 x 128; LU: 32768 x 2048 and the
``lu`` example's 16384 x 1024), one JSON line per dtype with the mean
microseconds of each part of a column, the call's time (CUDA events) and
its device time by kernel (one profiled call).  The stamps know three
column loops of ``lu_panel.cu``: the current one (key and pivot-row
reads, fused pass, publish and arrive, the rest of the update, the wait;
both dtypes raise one pivot key), the one before it, the same loop where
every warp of the float64 route reduced the G CTAs' candidates, and the
first design's (candidate reduction and pivot-row read, swap and scale,
rank-1 update, publish, grid barrier); and two of ``qr_panel.cu``: the
current one, whose float64 route closes each column at a counting
barrier, and the one before it, with grid.sync() in both dtypes.

``potrf`` follows every step (a 32-column diagonal block in float32, 64
in float64) of ``potrf_inv`` at w = 2048, in both dtypes, on two thread
blocks: block 0, which carries the serial chain (its panel strip, the
next diagonal block's update, factor and inverse, and the barriers), and
block 1, one of the blocks that apply the step's update.  The stamps know
two versions of ``potrf_kernel``: the current one, where float32 runs
FMA tiles and float64 DMMA tiles, 64-column blocks, a 16-column base and
counting grid barriers on the same schedule (the same stamps follow
both), and the earlier one, FMA tiles, 32-column blocks and generation
barriers in both dtypes.

A stamp is a few stores by one thread; the times are the copy's, not
the kernel's, and a part that follows thread 0 is its warp's share, the
rest of the block's landing in the next part.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path


def _ts(k: int, jc: str = "jc") -> str:
    return f"    PROBE_TS({jc} * 8 + {k});\n"


def _after(anchor: str, text: str):
    """A stamp placed after ``anchor``."""
    return anchor, anchor + text


def _at(k: int) -> str:
    return f"      PROBE_TS({k});\n"


#: the potrf stamps' slots: block 0 (the chain) and block 1 (a worker)
#: stamp 0 at a step's start and 6 past its last barrier; 1..5 mark parts
_POTRF_PARTS = {
    "chain": ((0, 1, "P: panel strip 0, its rows kept"),
              (1, 2, "next diagonal block read and updated"),
              (2, 3, "diagonal factor and inverse"),
              (3, 4, "diagonal written, P barrier"),
              (4, 6, "end barrier (the workers' update)")),
    "worker": ((0, 1, "P: panel and inverse-row tiles"),
               (1, 2, "P barrier"),
               (2, 5, "Q: trailing and inverse tiles"),
               (5, 6, "end barrier")),
}

def _potrf_stamps(current: bool):
    """The stamps of ``potrf_kernel``'s step loop: the current source's
    (``smem_prod`` picks each route's product, and each route its grid
    barriers), or the earlier FMA version's (``smem_mm``, ``grid_barrier``
    in both dtypes)."""
    if current:
        update, wait, p_barrier, end = (
            "smem_prod", "      if constexpr (!COUNTED) grid_wait_past(a.bar,"
            " gen);\n", "      grid_barrier(a.bar);\n    }\n",
            "    sync_all();\n")
    else:
        update, wait, p_barrier, end = (
            "smem_mm", "      grid_wait_past(a.bar, gen);\n",
            "      grid_barrier(a.bar);\n", "    grid_barrier(a.bar);\n")
    return [
        _after("    const int b2 = b1 + NB < w ? b1 + NB : w, nbn = b2 - b1;\n",
               _at(0)),
        ("    if (s + 1 == nsteps) break;\n",
         _at(1) + "    if (s + 1 == nsteps) break;\n"),
        _after(f"      {update}<true>(S, LS, X, LS, X, LS, nbn, nbn, nbs, 1,"
               " true);\n      __syncthreads();\n", _at(2)),
        _after("      diag_factor(S, X, gsm, nbn, a.b);\n", _at(3)),
        _after(wait, _at(4)),
        (p_barrier + "\n    // ---- phase Q",
         p_barrier + _at(2) + "\n    // ---- phase Q"),
        _after("                         nbs, vec, gsm, c, w, c, w, 1, 0, 0);\n"
               "        }\n      }\n", _at(5)),
        (end + "  }\n}\n", end + _at(6) + "  }\n}\n"),
    ]


def _lu_stamps(resolve: str):
    """The stamps of ``lu_panel.cu``'s column loop since the pivot-key design;
    ``resolve``, the line that reads column j's pivot row, tells the
    float64 route's two ways of reading it apart."""
    return [
        ("    const int jc = j - s, par = jc & 1;\n" + resolve,
         "    const int jc = j - s, par = jc & 1;\n" + _ts(0) + resolve),
        _after("      if (b == 0) sc.piv[j] = p;\n    }\n"
               "    __syncthreads();\n", _ts(1)),
        _after("      c = block_best(c, red);\n", _ts(2)),
        ("      target += G;\n      rest_update(A, rs, r0, i0, r1, jc,"
         " cw, ush);\n",
         "      target += G;\n" + _ts(3) +
         "      rest_update(A, rs, r0, i0, r1, jc, cw, ush);\n" + _ts(4)),
    ]


#: per kernel: the source, the versions of its column loop the stamps know
#: ((anchor, replacement) pairs; the part between consecutive stamps
#: named), the panel, and the inner chunk the stamps follow (its first
#: column)
_PROBES = {
    "qr": {
        "source": "qr_panel.cu",
        "panel": {"float32": (65536, 2048), "float64": (32768, 128)},
        "chunk": {"float32": 1024, "float64": 64},
        "versions": [{
            "name": "current: float64 on counting barriers",
            "stamps": [
                _after("    const int par = (j - s) & 1, jc = j - s;\n", _ts(0)),
                ("    __syncthreads();\n    const bool next = j + 1 < e;\n",
                 "    __syncthreads();\n" + _ts(1) +
                 "    const bool next = j + 1 < e;\n"),
                _after("      *a = *a / safe_denom;\n    }\n"
                       "    __syncthreads();\n", _ts(2)),
                ("    if (next) {\n      publish(acc, A, rs, cw, r0, r1, j + 1,"
                 " par ^ 1, sc, red);\n      column_barrier(grid, sc, target);"
                 "\n    }\n",
                 "    __syncthreads();\n" + _ts(3) +
                 "    if (next) {\n      publish(acc, A, rs, cw, r0, r1, j + 1,"
                 " par ^ 1, sc, red);\n" + _ts(4) +
                 "      column_barrier(grid, sc, target);\n    }\n"),
            ],
            "parts": ("partials and block barrier", "scalars and v pass",
                      "fused update-and-dot pass", "publish",
                      "grid barrier (float64: counting)"),
        }, {
            "name": "grid.sync in both dtypes",
            "stamps": [
                _after("    const int par = (j - s) & 1, jc = j - s;\n", _ts(0)),
                ("    __syncthreads();\n    const bool next = j + 1 < e;\n",
                 "    __syncthreads();\n" + _ts(1) +
                 "    const bool next = j + 1 < e;\n"),
                _after("      *a = *a / safe_denom;\n    }\n"
                       "    __syncthreads();\n", _ts(2)),
                ("    if (next) {\n      publish(acc, A, rs, cw, r0, r1, j + 1,"
                 " par ^ 1, sc, red);\n      grid.sync();\n    }\n",
                 "    __syncthreads();\n" + _ts(3) +
                 "    if (next) {\n      publish(acc, A, rs, cw, r0, r1, j + 1,"
                 " par ^ 1, sc, red);\n" + _ts(4) +
                 "      grid.sync();\n    }\n"),
            ],
            "parts": ("partials and block barrier", "scalars and v pass",
                      "fused update-and-dot pass", "publish", "grid barrier"),
        }],
    },
    "lu": {
        "source": "lu_panel.cu",
        "panel": {"float32": (32768, 2048), "float64": (16384, 1024)},
        "chunk": {"float32": 1024, "float64": 512},
        "versions": [{
            "name": "current: one pivot key in both dtypes",
            "stamps": _lu_stamps("    const int p = resolve(j, sc);\n"),
            "parts": ("key and pivot-row reads, swap stores",
                      "fused pass and block best", "publish and arrive",
                      "rest of the update (warp 0)", "wait"),
        }, {
            "name": "float64 candidates reduced in every warp",
            "stamps": _lu_stamps("    const int p = resolve(j, par, G, sc);\n"),
            "parts": ("key (float64: G candidates) and pivot-row reads, "
                      "swap stores", "fused pass and block best",
                      "publish and arrive", "rest of the update (warp 0)",
                      "wait"),
        }, {
            "name": "first design",
            "stamps": [
                _after("    const int par = (j - s) & 1;\n",
                       "    const int jc_probe = j - s;\n" + _ts(0, "jc_probe")),
                _after("      jsh[c] = __ldcg(&sc.jbuf[par * CW + c]);\n    }\n"
                       "    __syncthreads();\n", _ts(1, "jc_probe")),
                _after("      *a = *a / pivval;\n    }\n    __syncthreads();\n",
                       _ts(2, "jc_probe")),
                _after("        a[c] -= a[jc] * u;\n      }\n    }\n"
                       "    __syncthreads();\n", _ts(3, "jc_probe")),
                _after("      publish_candidate(A, rs, s, cw, r0, r1, j + 1, par ^ 1,"
                       " sc, red_v,\n                        red_i);\n",
                       _ts(4, "jc_probe")),
            ],
            "parts": ("candidate reduction and pivot-row read",
                      "swap and scale", "rank-1 update",
                      "publish (scan and block reduction)", "grid barrier"),
        }],
    },
    "potrf": {
        "source": "potrf_inv.cu",
        "panel": (2048, 2048),
        "versions": [{"name": "current: float32 FMA, float64 DMMA",
                      "stamps": _potrf_stamps(True),
                      "parts": {"float32": _POTRF_PARTS,
                                "float64": _POTRF_PARTS}},
                     {"name": "FMA tiles in both dtypes",
                      "stamps": _potrf_stamps(False),
                      "parts": {"float32": _POTRF_PARTS,
                                "float64": _POTRF_PARTS}}],
    },
}


#: the diagonal block's columns (a step's) of each version and dtype
_POTRF_NB = {"current: float32 FMA, float64 DMMA": {"float32": 32,
                                                     "float64": 64},
             "FMA tiles in both dtypes": {"float32": 32, "float64": 32}}

_POTRF_HEAD = """
__device__ unsigned long long probe_ts_buf[2 * 64 * 8];
#define PROBE_TS(slot) do { if (threadIdx.x == 0 && blockIdx.x < 2 && s < 64) { \\
    unsigned long long t_; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_)); \\
    probe_ts_buf[(blockIdx.x * 64 + s) * 8 + (slot)] = t_; } } while (0)
extern "C" int probe_ts(void* dst) {
  return cudaMemcpyFromSymbol(dst, probe_ts_buf, sizeof(probe_ts_buf));
}
"""

_HEAD = """
__device__ unsigned long long probe_ts_buf[8 * 64];
#define PROBE_TS(slot) do {{ if (threadIdx.x == 0 && blockIdx.x == 0 && \\
    s == (sizeof(T) == 8 ? {chunk64} : {chunk32})) {{ \\
    unsigned long long t_; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_)); \\
    probe_ts_buf[(slot)] = t_; }} }} while (0)
extern "C" int probe_ts(void* dst) {{
  return cudaMemcpyFromSymbol(dst, probe_ts_buf, sizeof(probe_ts_buf));
}}
"""


def _apply(src: str, stamps):
    """The source with one version's stamps in place, or None if an
    anchor is not found exactly once."""
    out = src
    for anchor, text in stamps:
        if out.count(anchor) != 1:
            return None
        out = out.replace(anchor, text)
    return out


def stamped_source(kind: str, src: str):
    """``(version name, parts, stamped source)`` for the first version of
    ``kind``'s column loop whose anchors the source holds; raises if none
    fits (the probe follows the kernel's column loop)."""
    probe = _PROBES[kind]
    head = (_POTRF_HEAD if kind == "potrf"
            else _HEAD.format(chunk32=probe["chunk"]["float32"],
                              chunk64=probe["chunk"]["float64"]))
    for version in probe["versions"]:
        out = _apply(src, version["stamps"])
        if out is not None and "#include <cstddef>\n" in out:
            out = out.replace("#include <cstddef>\n",
                              "#include <cstddef>\n" + head, 1)
            return version["name"], version["parts"], out
    raise RuntimeError(f"no {kind} probe anchors fit this source")


def _call(lib, kind, dt, M, k):
    """A closure making one call of the stamped ``kind`` build on a seeded
    ``dt`` panel as the wrapper makes it (its clone and scratch
    included), and the inner chunk's columns."""
    import torch
    name = "f64" if dt == torch.float64 else "f32"
    gmax = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    P = torch.randn(M, k, generator=gen, device="cuda", dtype=dt)
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "qr":
        lib.qr_panel_scratch.argtypes = [ctypes.c_int] * 3
        lib.qr_panel_scratch.restype = ctypes.c_longlong
        fn = getattr(lib, f"qr_panel_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws = torch.empty(lib.qr_panel_scratch(M, k, gmax), device="cuda",
                         dtype=dt)

        def run():
            out = P.clone()
            tau = torch.zeros(k, device="cuda", dtype=dt)
            T = torch.zeros(k, k, device="cuda", dtype=dt)
            if fn(out.data_ptr(), k, M, k, tau.data_ptr(), T.data_ptr(),
                  ws.data_ptr(), gmax, stream) != 0:
                raise RuntimeError("qr_panel probe: CUDA error")
        return run, 32
    inner = 64
    fn = getattr(lib, f"lu_panel_{name}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if hasattr(lib, "lu_panel_scratch"):
        for f in (lib.lu_panel_scratch, lib.lu_panel_words):
            f.argtypes = [ctypes.c_int] * 2
            f.restype = ctypes.c_longlong
        n_ws, n_wz = lib.lu_panel_scratch(k, gmax), lib.lu_panel_words(
            k, gmax)
    else:                                # the first design's fixed layout
        n_ws, n_wz = 2 * gmax * (inner + 1) + 2 * inner, gmax + k
    perm = torch.empty(M, dtype=torch.int64, device="cuda")
    ws = torch.empty(n_ws, device="cuda", dtype=dt)

    def run():
        out = P.clone()
        wz = torch.zeros(n_wz, dtype=torch.int64, device="cuda")
        if fn(out.data_ptr(), k, M, k, inner, perm.data_ptr(),
              ws.data_ptr(), wz.data_ptr(), gmax, stream) != 0:
            raise RuntimeError("lu_panel probe: CUDA error")
    return run, inner


def kernel_split(fn) -> dict:
    """One profiled call of ``fn``: {kernel name: [launches, device ms]},
    largest first, and the call's device-busy ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name = ev.name().replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0][:60]
        n, ms = per.get(name, (0, 0.0))
        per[name] = (n + 1, ms + ev.duration_ns() / 1e6)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][1])
    return {"busy_ms": round(sum(ms for _, ms in per.values()), 4),
            "kernels": {k: [n, round(ms, 4)] for k, (n, ms) in ranked}}


def _run_potrf(lib, w, _):
    """Stamps of a w x w block's factor in float32 and float64: {dtype
    name: array (2 blocks, 64 steps, 8 slots)} of the second call each."""
    import numpy as np
    import torch
    lib.potrf_inv_rowbuf.argtypes = [ctypes.c_int]
    lib.potrf_inv_rowbuf.restype = ctypes.c_longlong
    out = {}
    for dt in (torch.float32, torch.float64):
        fn = getattr(lib, "potrf_inv_f32" if dt == torch.float32
                     else "potrf_inv_f64")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        gen = torch.Generator(device="cuda")
        gen.manual_seed(w)
        G = torch.randn(w, w, generator=gen, device="cuda", dtype=dt)
        D = G @ G.T / w + w * torch.eye(w, device="cuda", dtype=dt)
        L, Li = torch.empty_like(D), torch.empty_like(D)
        Rb = torch.empty(lib.potrf_inv_rowbuf(w), device="cuda", dtype=dt)
        for _ in range(2):               # the second call is the one read
            bar = torch.zeros(2, dtype=torch.int32, device="cuda")
            err = fn(D.data_ptr(), w, w, 32, L.data_ptr(), Li.data_ptr(),
                     Rb.data_ptr(), bar.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"potrf_inv probe: CUDA error {err}")
        torch.cuda.synchronize()
        ts = np.zeros(2 * 64 * 8, dtype=np.uint64)
        if lib.probe_ts(ctypes.c_void_p(ts.ctypes.data)) != 0:
            raise RuntimeError("spine probe: reading the stamps failed")
        out[str(dt).replace("torch.", "")] = ts.reshape(2, 64, 8)
    return out


def potrf_split(ts, parts, steps: int) -> dict:
    """Mean microseconds a step of the potrf stamps ``ts`` (2 blocks, 64
    steps, 8 slots) spends in each part of ``parts`` ({role: ((slot from,
    slot to, name), ...)}: block 0 is the chain, block 1 the worker), over
    the steps that reach their end barrier, and the mean step (block 0's
    start to its next start)."""
    import numpy as np
    t = ts.astype(np.float64) / 1e3
    out = {}
    for blk, role in enumerate(("chain", "worker")):
        out[role] = {name: round(float(np.mean(t[blk, :steps - 1, b]
                                               - t[blk, :steps - 1, a])), 3)
                     for a, b, name in parts[role]}
    out["step_us"] = round(float(np.mean(np.diff(t[0, :steps, 0]))), 3)
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch
    from . import common
    ap = argparse.ArgumentParser(prog="spine_probe")
    ap.add_argument("kind", nargs="?", default="qr", choices=sorted(_PROBES))
    ap.add_argument("--src", type=Path, default=None,
                    help="directory holding the kernel source and headers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spine_probe: no CUDA device", file=sys.stderr)
        return 1
    probe = _PROBES[args.kind]
    src_dir = args.src or common.CSRC
    work = common.BUILD_DIR / "spine_probe" / args.kind
    work.mkdir(parents=True, exist_ok=True)
    for header in list(common.CSRC.glob("*.cuh")) + list(src_dir.glob("*.cuh")):
        shutil.copy(header, work / header.name)
    version, parts, text = stamped_source(
        args.kind, (src_dir / probe["source"]).read_text())
    (work / probe["source"]).write_text(text)
    lib_path = work / f"lib{args.kind}_probe.so"
    subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib_path),
                    str(work / probe["source"])], check=True)
    lib = ctypes.CDLL(str(lib_path))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.kind == "potrf":
        M, k = probe["panel"]
        stamps = _run_potrf(lib, M, k)
        print(json.dumps({"probe": "potrf_inv.cu steps", "version": version,
                          "w": M, "us_per_step": {
                              name: potrf_split(ts, parts[name],
                                                -(-M // _POTRF_NB[version][
                                                    name]))
                              for name, ts in stamps.items()},
                          "card": card}))
        return 0
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        M, k = probe["panel"][name]
        run, cw = _call(lib, args.kind, dt, M, k)
        for _ in range(2):               # the second call is the one read
            run()
        torch.cuda.synchronize()
        ts = np.zeros(8 * 64, dtype=np.uint64)
        if lib.probe_ts(ctypes.c_void_p(ts.ctypes.data)) != 0:
            raise RuntimeError("spine probe: reading the stamps failed")
        cols = cw - 1                    # the chunk's columns with a barrier
        split = np.zeros(len(parts))
        for jc in range(cols):
            t = [int(ts[jc * 8 + u]) for u in range(len(parts))]
            t.append(int(ts[(jc + 1) * 8]))
            split += np.diff(np.array(t, dtype=np.float64)) / 1e3
        split /= cols
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({"probe": f"{probe['source']} spine",
                          "version": version, "dtype": name, "panel": [M, k],
                          "chunk": probe["chunk"][name],
                          "us_per_column": dict(zip(parts,
                                                    split.round(3).tolist())),
                          "total_us": round(float(split.sum()), 3),
                          "call_ms": round(start.elapsed_time(end) / 5, 4),
                          "call_split": kernel_split(run), "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
