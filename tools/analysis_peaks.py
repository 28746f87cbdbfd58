#!/usr/bin/env python3
"""Per-driver memory peaks: the port's measured ``memory_plan/v1`` peak
against the JAX package's liveness walk, on the CPU.

For every registered driver on 1x1 and 2x2 (n = 64, nb = 16, float32)
it prints one markdown table row: the port's ``peak_bytes`` (the
allocator's events, ``elemental_tpu_torch.analysis.trace_memory``) and
the JAX package's (``elemental_tpu.analysis.trace_memory``, traced on a
virtual 8-device CPU mesh in x64 mode, as its tests and CLI run), each
with its ratio to the input + output residency, and whether the port
lints clean (EL006 / EL007).  A comparison tool: it imports both
packages; the port itself imports no JAX.

    python3 tools/analysis_peaks.py            # all 33 drivers
    python3 tools/analysis_peaks.py lu qr      # drivers by prefix
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


def main(argv=None) -> int:
    import jax
    jax.config.update("jax_platform_name", "cpu")
    jax.config.update("jax_enable_x64", True)
    import elemental_tpu as el
    import elemental_tpu_torch as et
    from elemental_tpu import analysis as jan
    from elemental_tpu_torch import analysis as an

    prefixes = list(sys.argv[1:] if argv is None else argv)
    names = [d for d in an.driver_names()
             if not prefixes or any(d.startswith(p) for p in prefixes)]
    print("| driver | port 1x1 B (ratio) | JAX 1x1 B (ratio) "
          "| port 2x2 B (ratio) | JAX 2x2 B (ratio) | port lint |")
    print("|---|---|---|---|---|---|")
    for name in names:
        cells, lint = [], []
        for rc in ((1, 1), (2, 2)):
            tp = an.trace_memory(name, et.Grid(*rc, device="cpu"))[0]
            jg = el.Grid(jax.devices()[: rc[0] * rc[1]], height=rc[0])
            jp = jan.trace_memory(name, jg)[0]
            for mp in (tp, jp):
                base = mp.stats.args_bytes + mp.stats.outs_bytes
                cells.append(f"{mp.peak_bytes} ({mp.peak_bytes / base:.2f})")
            lint += [f"{f.rule} {rc[0]}x{rc[1]}"
                     for f in an.lint_memory(tp)]
        print(f"| `{name}` | " + " | ".join(cells) + " | "
              + (", ".join(lint) or "clean") + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
