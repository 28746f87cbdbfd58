"""Time the block-reflector triangle builds against each other on the card.

    python3 -m elemental_tpu_torch.kernels.larft_timing

Times ``apply_q`` at the least-squares path's shape (m = 65536, n = 32768,
nb = 2048, Q^H applied to 8 columns) and ``apply_q_herm_tridiag`` at the
eigensolver path's (N = 16384, nb = 512, Q applied to N columns), float32,
each with T built two ways in turns (blocked, recurrence, recurrence,
blocked): the blocked :func:`~.qr_panel._larft` and the column recurrence
the JAX package's ``_larft`` runs (k dependent matrix-vector steps a
panel, kept here as the reference).  The reflectors are random unit-lower
Householder vectors with tau = 2 / ||v||^2, so each Q is orthogonal; the
timings do not depend on where they came from.  It also times one T build
at each path's panel shape and reports the two builds' largest difference.
Prints one JSON line.
"""
from __future__ import annotations

import json
import sys
import time

import torch


def larft_recurrence(V, tau):
    """T of Q = I - V T V^H by the column recurrence ``T[:i, i] = -tau_i
    T[:i, :i] (V^H V)[:i, i]`` (the JAX package's ``_larft``), built as
    rows of T^T."""
    k = tau.shape[0]
    B = V.conj().mT @ V
    Bt = B.mT.contiguous()
    Tt = torch.diag(tau)
    ntau = -tau
    for i in range(1, k):
        row = Tt[i, :i]
        torch.mv(Tt[:i, :i].mT, Bt[i, :i], out=row)
        row.mul_(ntau[i])
    return Tt.mT.contiguous()


def _reflectors(m: int, n: int, gen):
    """A packed (m, n) factor with random tails below the unit diagonal
    (scaled by 1/sqrt(m)) and the tau that makes each reflector
    orthogonal."""
    P = torch.randn(m, n, generator=gen, device="cuda").div_(m ** 0.5)
    tail2 = torch.tril(P, -1).pow(2).sum(dim=0)
    return P, 2.0 / (1.0 + tail2)


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def main() -> int:
    if not torch.cuda.is_available():
        print("larft_timing: no CUDA device", file=sys.stderr)
        return 1
    import elemental_tpu_torch as et
    from elemental_tpu_torch.kernels.qr_panel import _larft, _panel_v
    torch.backends.cuda.matmul.allow_tf32 = False
    qr_mod = sys.modules["elemental_tpu_torch.lapack.qr"]
    cond = sys.modules["elemental_tpu_torch.lapack.condense"]
    builds = {"blocked": _larft, "recurrence": larft_recurrence}
    grid = et.Grid()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}

    # apply_q at the least-squares path's shape
    m, n, nb = 65536, 32768, 2048
    P, tau = _reflectors(m, n, gen)
    Ap = et.DistMatrix(P, (m, n), et.MC, et.MR, 0, 0, grid)
    B = et.from_global(torch.randn(m, 8, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    V0 = _panel_v(P[:, :nb])
    T_b, T_r = _larft(V0, tau[:nb]), larft_recurrence(V0, tau[:nb])
    out["apply_q_panel_T_max_diff"] = float((T_b - T_r).abs().max())
    for name, fn in builds.items():
        out[f"T_{m}x{nb}_{name}_s"] = _wall(lambda: fn(V0, tau[:nb]))
    del V0
    for name in ("blocked", "recurrence", "recurrence", "blocked"):
        qr_mod._larft = builds[name]
        t = _wall(lambda: et.apply_q(Ap, tau, B, orient="C", nb=nb))
        out.setdefault(f"apply_q_{name}_s", []).append(t)
    del P, Ap, B

    # apply_q_herm_tridiag at the eigensolver path's shape
    N, nb = 16384, 512
    P, tau = _reflectors(N, N - 1, gen)
    P = torch.nn.functional.pad(torch.tril(P, -1), (0, 1))  # tails at j+2
    P = torch.roll(P, 1, dims=0)
    Ap = et.DistMatrix(P, (N, N), et.MC, et.MR, 0, 0, grid)
    Z = et.from_global(torch.randn(N, N, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    for name in ("blocked", "recurrence", "recurrence", "blocked"):
        cond._larft = builds[name]
        t = _wall(lambda: et.apply_q_herm_tridiag(Ap, tau, Z, nb=nb))
        out.setdefault(f"apply_q_herm_tridiag_{name}_s", []).append(t)
    qr_mod._larft = cond._larft = _larft
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out["card"] = card
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
