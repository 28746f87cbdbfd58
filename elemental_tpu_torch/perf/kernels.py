"""Panel-kernel smoke CLI (the twin of the JAX package's ``perf/kernels.py``).

    python -m elemental_tpu_torch.perf.kernels smoke
                        # clean runs of the three hand-written panel
                        #   kernels through the real drivers on the 1x1
                        #   and a virtual 2x2 grid

``smoke`` is the cheap always-on gate: every driver factors a small
float32 matrix with ``panel_impl='kernel'``, the factor residuals must sit
under :data:`TOL`, and the LU pivot sequence must be IDENTICAL to the
plain route's (``panel_impl='torch'``).  On the card each kernel must
also have launched; on the CPU (``--device cpu``) the kernel route is each
kernel's plain version, the port's counterpart of Pallas interpret mode.
Exits non-zero on any violation, naming the grid and, for a pivot
mismatch, the first column whose pivot differs.  Runs on ``cuda:0``
unless ``--device cpu``; without a card it exits 2.
"""
from __future__ import annotations

import sys

#: residual ceiling of the smoke gate, a generous multiple of the float32
#: residuals (~1e-7 at n = 48), as the JAX smoke's
TOL = 5e-5


def _run_smoke(device) -> int:
    import numpy as np
    import torch
    import elemental_tpu_torch as el
    from elemental_tpu_torch import kernels

    n, nb = 48, 8
    rng = np.random.default_rng(17)
    F = rng.normal(size=(n, n)).astype(np.float32)
    S = (F @ F.T / n + n * np.eye(n)).astype(np.float32)
    failures = []
    kerns = (kernels.potrf_inv, kernels.lu_panel, kernels.qr_panel)
    before = [k.launches for k in kerns]

    def check(tag, resid, tol=TOL):
        ok = resid < tol
        print(f"{'ok ' if ok else 'FAIL'} {tag:40s} resid {resid:.2e}"
              f" (tol {tol:.0e})", flush=True)
        if not ok:
            failures.append(tag)

    def host(X):
        return el.to_global(X).cpu().numpy()

    for r, c in ((1, 1), (2, 2)):
        grid = el.Grid(r, c, device=device)
        A = el.from_global(F, el.MC, el.MR, grid=grid)
        Aspd = el.from_global(S, el.MC, el.MR, grid=grid)

        # lu: residual + pivot identity against the plain route
        LU, perm = el.lu(A, nb=nb, panel_impl="kernel")
        lu_, perm = host(LU), perm.cpu().numpy()
        L = np.tril(lu_, -1) + np.eye(n, dtype=np.float32)
        check(f"lu {r}x{c} kernel",
              np.linalg.norm(L @ np.triu(lu_) - F[perm]) / np.linalg.norm(F))
        _, perm_t = el.lu(A, nb=nb, panel_impl="torch")
        differ = np.flatnonzero(perm != perm_t.cpu().numpy())
        if differ.size:
            print(f"FAIL lu {r}x{c} pivot sequence differs from torch at "
                  f"column {int(differ[0])} ({differ.size} rows of the "
                  f"permutation differ; the matrix is "
                  f"default_rng(17).normal(size=({n}, {n})), float32)",
                  flush=True)
            failures.append(f"lu {r}x{c} pivots")
        else:
            print(f"ok  lu {r}x{c} pivots identical to torch", flush=True)

        # cholesky: factor residual of the potrf_inv kernel's blocks
        lg = host(el.cholesky(Aspd, nb=nb, panel_impl="kernel"))
        check(f"cholesky {r}x{c} kernel",
              np.linalg.norm(lg @ lg.T - S) / np.linalg.norm(S))

        # qr: reconstruction through the geqrf reflectors of the qr_panel
        # kernel (Q = H_0 ... H_{k-1}, R = triu(packed))
        packed, tau = el.qr(A, nb=nb, panel_impl="kernel")
        pg, tg = host(packed), tau.cpu().numpy()
        Qm = np.eye(n)
        for j in range(n):
            v = np.zeros(n)
            v[j] = 1.0
            v[j + 1:] = pg[j + 1:, j]
            Qm = Qm @ (np.eye(n) - tg[j] * np.outer(v, v))
        check(f"qr {r}x{c} kernel recon",
              np.linalg.norm(Qm @ np.triu(pg) - F) / np.linalg.norm(F))
        check(f"qr {r}x{c} kernel ortho",
              np.linalg.norm(Qm.T @ Qm - np.eye(n)) / np.sqrt(n))

    launched = {k.__name__: k.launches - b for k, b in zip(kerns, before)}
    if torch.device(device).type == "cuda":
        print(f"kernel launches {launched}", flush=True)
        failures += [f"{name} never launched"
                     for name, count in launched.items() if count == 0]
    if failures:
        print(f"SMOKE FAILED: {failures}", flush=True)
        return 1
    print("kernels smoke OK", flush=True)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = argv.pop(0) if argv else "smoke"
    device = "cuda"
    if argv[:1] == ["--device"] and len(argv) == 2:
        device = argv[1]
    elif argv:
        raise SystemExit(f"unknown arguments {argv}")
    if mode != "smoke":
        print(__doc__)
        return 2
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("kernels: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run_smoke(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


if __name__ == "__main__":
    raise SystemExit(main())
