"""Measurement engine: time candidate configs on the grid's device and
record winners in the persistent cache.

PyTorch port of ``elemental_tpu/tune/measure.py``.  Every candidate runs
in one process on the same device; timings are min-of-reps with the host
round-trip latency subtracted, fenced by ``torch.cuda.synchronize()`` on
the card, and each candidate is bracketed by a full-float32 matmul
roofline measurement so the card's clock state is factored out of the
comparison.  The drivers factor their 1x1 input in place, so every rep
gets a fresh copy of the seeded input, made untimed.

``search()`` is the entry of ``python -m elemental_tpu_torch.tune
search``: it pre-ranks the candidate space with the analytic cost model
(cheap), times the top slice, and atomically persists the winner as a
``tuning_cache/v1`` entry that every later ``'auto'`` resolution on the
same (op, shape-bucket, dtype, grid, backend) key picks up first.  On a
CUDA grid everything runs on the card: nothing falls back to the CPU, and
a kernel's build or launch error propagates.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

from . import cache as _cache
from .cost_model import op_flops
from .policy import dtype_name, explain


@dataclasses.dataclass
class Measured:
    """One timed candidate."""
    config: dict
    seconds: float
    tflops: float
    roofline_tflops: float

    def to_doc(self) -> dict:
        return {"config": dict(self.config), "seconds": self.seconds,
                "tflops": self.tflops,
                "roofline_tflops": self.roofline_tflops}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _full_f32():
    """Full-float32 matmuls for the block (TF32 off), restored after: the
    drivers refuse to run on the card with TF32 on."""
    import torch
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _rep(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _latency(device) -> float:
    """Host round trip of one tiny fenced op (subtracted from each time)."""
    import torch
    t = torch.zeros((), device=device)

    def tiny():
        (t + 1.0)
        _sync(device)
    tiny()
    return min(_rep(tiny) for _ in range(3))


def _roofline(lat: float, device, n: int = 2048) -> float:
    """TFLOP/s of one full-float32 ``torch.matmul`` of an n x n matrix."""
    import torch
    gen = torch.Generator(device=device).manual_seed(9)
    R = torch.randn((n, n), generator=gen, device=device,
                    dtype=torch.float32)

    def mm():
        torch.matmul(R, R)
        _sync(device)
    with _full_f32():
        mm()
        dt = max(min(_rep(mm) for _ in range(3)) - lat, 1e-9)
    return 2 * n ** 3 / dt / 1e12


def _builders(op: str, dims, grid, dtype):
    """(make_input, step_factory) for one op: ``make_input()`` returns a
    fresh copy of the seeded input (untimed); ``step_factory(config)``
    returns the driver call under that config, ``panel_impl`` included."""
    import torch
    import elemental_tpu_torch as et

    dev = grid.device
    tdt = getattr(torch, dtype_name(dtype))
    HI = "highest"

    def rnd(seed, m, n):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn((m, n), generator=gen, device=dev, dtype=tdt)

    def dm(a):
        return et.from_global(a, et.MC, et.MR, grid)

    def fresh(*mats):
        def make():
            out = tuple(dm(x.clone()) for x in mats)
            return out if len(out) > 1 else out[0]
        return make

    if op == "cholesky":
        n = dims[0]
        G = rnd(0, n, n)
        with _full_f32():
            S = torch.matmul(G, G.mT) / n
        del G
        S.diagonal().add_(n)

        def factory(cfg):
            return lambda a: et.cholesky(
                a, nb=cfg.get("nb"), lookahead=cfg.get("lookahead", True),
                crossover=cfg.get("crossover"),
                panel_impl=cfg.get("panel_impl"),
                comm_precision=cfg.get("comm_precision"),
                redist_path=cfg.get("redist_path"), precision=HI)
        return fresh(S), factory
    if op == "lu":
        m, n = dims[0], dims[-1]

        def factory(cfg):
            return lambda a: et.lu(
                a, nb=cfg.get("nb"), lookahead=cfg.get("lookahead", True),
                crossover=cfg.get("crossover"),
                panel=cfg.get("panel") or "classic",
                panel_impl=cfg.get("panel_impl"),
                comm_precision=cfg.get("comm_precision"),
                redist_path=cfg.get("redist_path"), precision=HI)
        return fresh(rnd(1, m, n)), factory
    if op == "qr":
        m, n = dims[0], dims[-1]

        def factory(cfg):
            return lambda a: et.qr(
                a, nb=cfg.get("nb"), panel=cfg.get("panel") or "classic",
                panel_impl=cfg.get("panel_impl"),
                comm_precision=cfg.get("comm_precision"),
                redist_path=cfg.get("redist_path"), precision=HI)
        return fresh(rnd(2, m, n)), factory
    if op == "trsm":
        m, n = dims[0], dims[-1]
        a = torch.tril(rnd(3, m, m))
        a.diagonal().add_(m)                  # well-conditioned

        def factory(cfg):
            return lambda ab: et.trsm(
                "L", "L", "N", ab[0], ab[1], nb=cfg.get("nb"),
                comm_precision=cfg.get("comm_precision"),
                redist_path=cfg.get("redist_path"), precision=HI)
        return fresh(a, rnd(4, m, n)), factory
    if op == "herk":
        m, k = dims[0], dims[-1]

        def factory(cfg):
            return lambda a: et.herk(
                "L", a, nb=cfg.get("nb"),
                comm_precision=cfg.get("comm_precision"),
                redist_path=cfg.get("redist_path"), precision=HI)
        return fresh(rnd(5, m, k)), factory
    if op == "gemm":
        m, k, n = dims

        def factory(cfg):
            return lambda ab: et.gemm(
                ab[0], ab[1], alg=cfg.get("alg", "auto"), nb=cfg.get("nb"),
                comm_precision=cfg.get("comm_precision"),
                redist_path=cfg.get("redist_path"), precision=HI)
        return fresh(rnd(6, m, k), rnd(7, k, n)), factory
    raise KeyError(f"no measurement builder for op {op!r}")


def measure_candidates(op: str, dims, grid, dtype, candidates,
                       reps: int = 3, verbose: bool = False) -> list:
    """Time each candidate config (roofline-bracketed); best-first list."""
    dev = grid.device
    flops = op_flops(op, dims)
    out = []
    with _full_f32():
        make, factory = _builders(op, dims, grid, dtype)
        lat = _latency(dev)
        for cfg in candidates:
            step = factory(cfg)
            first = step(make())                   # warm (kernel builds)
            _sync(dev)
            del first
            r0 = _roofline(lat, dev)
            times = []
            for _ in range(reps):
                A = make()
                _sync(dev)
                t0 = time.perf_counter()
                o = step(A)
                _sync(dev)
                times.append(time.perf_counter() - t0)
                del o, A
            r1 = _roofline(lat, dev)
            dt = max(min(times) - lat, 1e-9)
            m = Measured(config=dict(cfg), seconds=dt,
                         tflops=flops / dt / 1e12,
                         roofline_tflops=0.5 * (r0 + r1))
            out.append(m)
            if verbose:
                print(f"  {str(cfg):60s} {dt * 1e3:9.2f} ms "
                      f"{m.tflops:7.3f} TFLOP/s (roof "
                      f"{m.roofline_tflops:.2f})", flush=True)
    out.sort(key=lambda m: m.seconds)
    return out


def search(op: str, dims, grid, dtype, requested: dict | None = None,
           top: int = 8, reps: int = 3, write_cache: bool = True,
           verbose: bool = False):
    """Cost-model-pre-ranked measurement sweep; persists the winner.

    Returns ``(winner: Measured, all_measured: list, key)``.  The cache
    entry records the measured config with ``source='measured'`` so later
    ``'auto'`` resolutions on this key skip the cost model.  On the card
    ('gpu') the plain panels (``panel_impl='torch'``) are not measured
    unless ``requested`` pins them: they take ~100x the kernel's time.
    """
    ctx, scored = explain(op, gshape=dims, dtype=dtype, grid=grid,
                          requested=requested)
    pinned_impl = requested is not None \
        and requested.get("panel_impl", "auto") != "auto"
    if ctx.backend == "gpu" and not pinned_impl:
        scored = [b for b in scored
                  if b.config.get("panel_impl") != "torch"]
    cands = [b.config for b in scored[:max(1, top)]]
    if verbose:
        print(f"{op} {tuple(dims)} on {ctx.grid_shape[0]}x"
              f"{ctx.grid_shape[1]} {ctx.backend}: measuring "
              f"{len(cands)}/{len(scored)} cost-ranked candidates",
              flush=True)
    measured = measure_candidates(op, dims, grid, dtype, cands, reps=reps,
                                  verbose=verbose)
    winner = measured[0]
    key = _cache.make_key(op, ctx.dims, ctx.dtype, ctx.grid_shape,
                          ctx.backend)
    if write_cache:
        _cache.save(key, winner.config, source="measured",
                    metric={"seconds": winner.seconds,
                            "tflops": winner.tflops,
                            "roofline_tflops": winner.roofline_tflops})
        from .policy import clear_memo
        clear_memo()                       # new winner visible immediately
    return winner, measured, key


__all__ = ["Measured", "measure_candidates", "search"]
