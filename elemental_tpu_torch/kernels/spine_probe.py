"""Where one column of a panel kernel's spine spends its time, on the card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 -m elemental_tpu_torch.kernels.spine_probe [qr|lu] [--src DIR]

The committed kernels have no probe switch.  This script copies the
kernel's source (``csrc/qr_panel.cu`` or ``csrc/lu_panel.cu``; with
``--src``, the one in DIR and the headers beside it, such as an earlier
revision taken from git history) and its headers into
``kernels/build/spine_probe/`` (ignored by git), inserts ``%globaltimer``
stamps into the copy's column loop (thread 0 of thread block 0, one inner
chunk in the middle of the panel), builds it with the port's ``nvcc``
flags, factors a float32 panel with it (65536 x 2048 for QR, 32768 x
2048 for LU) and prints, as one JSON line, the mean time a column spends
between consecutive stamps.  The stamps know two column loops of
``lu_panel.cu``: the current one (key and pivot-row reads, fused pass,
publish and arrive, the rest of the update, the wait) and the first
design's (candidate reduction and pivot-row read, swap and scale, rank-1
update, publish, grid barrier).  A stamp is a few stores by one thread;
the times are the copy's, not the kernel's, and a part that follows
thread 0 (the rest of the update) is its warp's share, the rest of the
block's landing in the next part.
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


#: per kernel: the source, the versions of its column loop the stamps know
#: ((anchor, replacement) pairs; the part between consecutive stamps
#: named), the panel, and the inner chunk the stamps follow (its first
#: column)
_PROBES = {
    "qr": {
        "source": "qr_panel.cu",
        "panel": (65536, 2048),
        "chunk": 1024,
        "versions": [{
            "name": "current",
            "stamps": [
                _after("    const int par = (j - s) & 1, jc = j - s;\n", _ts(0)),
                _after("    const T alpha = __ldcg(&sc.jbuf[par * CW + jc]);\n"
                       "    __syncthreads();\n", _ts(1)),
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
        "panel": (32768, 2048),
        "chunk": 1024,
        "versions": [{
            "name": "current",
            "stamps": [
                _after("    const int jc = j - s, par = jc & 1;\n", _ts(0)),
                _after("      if (b == 0) sc.piv[j] = p;\n    }\n"
                       "    __syncthreads();\n", _ts(1)),
                _after("      c = block_best(c, red);\n", _ts(2)),
                ("      target += G;\n      rest_update(A, rs, r0, i0, r1, jc,"
                 " cw, ush);\n",
                 "      target += G;\n" + _ts(3) +
                 "      rest_update(A, rs, r0, i0, r1, jc, cw, ush);\n" +
                 _ts(4)),
            ],
            "parts": ("key and pivot-row reads, swap stores",
                      "fused pass and block best", "publish and arrive",
                      "rest of the update (warp 0)", "wait"),
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
}

_HEAD = """
__device__ unsigned long long probe_ts_buf[8 * 64];
#define PROBE_TS(slot) do {{ if (threadIdx.x == 0 && blockIdx.x == 0 && s == {chunk}) {{ \\
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
    head = _HEAD.format(chunk=probe["chunk"])
    for version in probe["versions"]:
        out = _apply(src, version["stamps"])
        if out is not None and "#include <cstddef>\n" in out:
            out = out.replace("#include <cstddef>\n",
                              "#include <cstddef>\n" + head, 1)
            return version["name"], version["parts"], out
    raise RuntimeError(f"no {kind} probe anchors fit this source")


def _run_qr(lib, M, k):
    import torch
    lib.qr_panel_scratch.argtypes = [ctypes.c_int] * 3
    lib.qr_panel_scratch.restype = ctypes.c_longlong
    fn = lib.qr_panel_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    P = torch.randn(M, k, generator=gen, device="cuda")
    gmax = torch.cuda.get_device_properties(0).multi_processor_count
    ws = torch.empty(lib.qr_panel_scratch(M, k, gmax), device="cuda")
    for _ in range(2):                   # the second call is the one read
        out = P.clone()
        tau = torch.zeros(k, device="cuda")
        T = torch.zeros(k, k, device="cuda")
        err = fn(out.data_ptr(), k, M, k, tau.data_ptr(), T.data_ptr(),
                 ws.data_ptr(), gmax, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"qr_panel probe: CUDA error {err}")
    return 32                            # the inner chunk's columns


def _run_lu(lib, M, nbw):
    import torch
    inner = 64
    fn = lib.lu_panel_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gmax = torch.cuda.get_device_properties(0).multi_processor_count
    if hasattr(lib, "lu_panel_scratch"):
        for f in (lib.lu_panel_scratch, lib.lu_panel_words):
            f.argtypes = [ctypes.c_int] * 2
            f.restype = ctypes.c_longlong
        n_ws, n_wz = lib.lu_panel_scratch(nbw, gmax), lib.lu_panel_words(
            nbw, gmax)
    else:                                # the first design's fixed layout
        n_ws, n_wz = 2 * gmax * (inner + 1) + 2 * inner, gmax + nbw
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    P = torch.randn(M, nbw, generator=gen, device="cuda")
    perm = torch.empty(M, dtype=torch.int64, device="cuda")
    ws = torch.empty(n_ws, device="cuda")
    for _ in range(2):                   # the second call is the one read
        out = P.clone()
        wz = torch.zeros(n_wz, dtype=torch.int64, device="cuda")
        err = fn(out.data_ptr(), nbw, M, nbw, inner, perm.data_ptr(),
                 ws.data_ptr(), wz.data_ptr(), gmax,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"lu_panel probe: CUDA error {err}")
    return inner


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
    M, k = probe["panel"]
    run = _run_qr if args.kind == "qr" else _run_lu
    cw = run(lib, M, k)
    torch.cuda.synchronize()
    ts = np.zeros(8 * 64, dtype=np.uint64)
    if lib.probe_ts(ctypes.c_void_p(ts.ctypes.data)) != 0:
        raise RuntimeError("spine probe: reading the stamps failed")
    cols = cw - 1                        # the chunk's columns with a barrier
    split = np.zeros(len(parts))
    for jc in range(cols):
        t = [int(ts[jc * 8 + u]) for u in range(len(parts))]
        t.append(int(ts[(jc + 1) * 8]))
        split += np.diff(np.array(t, dtype=np.float64)) / 1e3
    split /= cols
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"probe": f"{probe['source']} spine", "version": version,
                      "panel": [M, k], "chunk": probe["chunk"],
                      "us_per_column": dict(zip(parts,
                                                split.round(3).tolist())),
                      "total_us": round(float(split.sum()), 3),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
