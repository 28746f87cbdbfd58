"""Where one column of ``qr_panel``'s spine spends its time, on the card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 -m elemental_tpu_torch.kernels.spine_probe

The committed kernel has no probe switch.  This script copies
``csrc/qr_panel.cu`` and its headers into ``kernels/build/spine_probe/``
(ignored by git), inserts ``%globaltimer`` stamps into the copy's column
loop (thread 0 of thread block 0, one inner chunk in the middle of the
panel), builds it with the port's ``nvcc`` flags, factors a 65536 x 2048
float32 panel with it, and prints the mean time a column spends in each
part: the fixed-order sum of the partials and its block barrier, the
larfg scalars with the v pass, the fused update-and-dot pass, the
publication of the next partials, and the grid barrier.  The stamps add
a few stores to one thread; the times are the copy's, not the kernel's.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

#: (anchor in qr_panel.cu, text inserted after it); stamp k of column jc
#: goes to slot 8 jc + k
_STAMPS = [
    ("    const int par = (j - s) & 1, jc = j - s;\n", "    PROBE_TS(jc * 8 + 0);\n"),
    ("    const T alpha = __ldcg(&sc.jbuf[par * CW + jc]);\n    __syncthreads();\n",
     "    PROBE_TS(jc * 8 + 1);\n"),
    ("      *a = *a / safe_denom;\n    }\n    __syncthreads();\n",
     "    PROBE_TS(jc * 8 + 2);\n"),
]
_PUBLISH = ("    if (next) {\n      publish(acc, A, rs, cw, r0, r1, j + 1, par ^ 1, sc, red);\n"
            "      grid.sync();\n    }\n")
_PUBLISH_STAMPED = ("    __syncthreads();\n    PROBE_TS(jc * 8 + 3);\n"
                    "    if (next) {\n      publish(acc, A, rs, cw, r0, r1, j + 1, par ^ 1, sc, red);\n"
                    "      PROBE_TS(jc * 8 + 4);\n      grid.sync();\n    }\n")
#: the inner chunk the stamps follow (its first column)
CHUNK = 1024
_HEAD = f"""
__device__ unsigned long long probe_ts_buf[8 * 64];
#define PROBE_TS(slot) do {{ if (threadIdx.x == 0 && blockIdx.x == 0 && s == {CHUNK}) {{ \\
    unsigned long long t_; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_)); \\
    probe_ts_buf[(slot)] = t_; }} }} while (0)
extern "C" int probe_ts(void* dst) {{
  return cudaMemcpyFromSymbol(dst, probe_ts_buf, sizeof(probe_ts_buf));
}}
"""
PARTS = ("partials and block barrier", "scalars and v pass",
         "fused update-and-dot pass", "publish", "grid barrier")


def stamped_source(src: str) -> str:
    """The kernel's source with the stamps inserted; raises if an anchor
    is missing (the probe follows the committed column loop)."""
    out = src.replace('#include "fast_gemm.cuh"\n',
                      '#include "fast_gemm.cuh"\n' + _HEAD, 1)
    for anchor, stamp in _STAMPS:
        if out.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        out = out.replace(anchor, anchor + stamp)
    if out.count(_PUBLISH) != 1:
        raise RuntimeError("probe anchor not found once: the publish step")
    return out.replace(_PUBLISH, _PUBLISH_STAMPED)


def main() -> int:
    import numpy as np
    import torch
    from . import common
    if not torch.cuda.is_available():
        print("spine_probe: no CUDA device", file=sys.stderr)
        return 1
    work = common.BUILD_DIR / "spine_probe"
    work.mkdir(parents=True, exist_ok=True)
    for header in common.CSRC.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    (work / "qr_panel.cu").write_text(
        stamped_source((common.CSRC / "qr_panel.cu").read_text()))
    lib_path = work / "libqr_probe.so"
    subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib_path),
                    str(work / "qr_panel.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.qr_panel_scratch.argtypes = [ctypes.c_int] * 3
    lib.qr_panel_scratch.restype = ctypes.c_longlong
    fn = lib.qr_panel_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M, k = 65536, 2048
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
    torch.cuda.synchronize()
    ts = np.zeros(8 * 64, dtype=np.uint64)
    if lib.probe_ts(ctypes.c_void_p(ts.ctypes.data)) != 0:
        raise RuntimeError("qr_panel probe: reading the stamps failed")
    cols = 31                            # the chunk's columns with a barrier
    split = np.zeros(len(PARTS))
    for jc in range(cols):
        t = [int(ts[jc * 8 + u]) for u in range(5)] + [int(ts[(jc + 1) * 8])]
        split += np.diff(np.array(t, dtype=np.float64)) / 1e3
    split /= cols
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"probe": "qr_panel spine", "panel": [M, k],
                      "chunk": CHUNK, "us_per_column": dict(
                          zip(PARTS, split.round(3).tolist())),
                      "total_us": round(float(split.sum()), 3),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
