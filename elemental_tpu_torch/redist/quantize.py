"""Block-scaled wire codecs of the quantized-collective path.

PyTorch port of ``elemental_tpu/redist/quantize.py``, whole: the codec
of the ``comm_precision`` knob (the EQuARX direction, PAPERS.md arXiv
2506.17615).  The engine (:mod:`.engine`) decides where it runs.

``'bf16'``
    a plain cast: 2x fewer bytes, ~3 decimal digits of mantissa.

``'int8'``
    block-scaled integer quantization: per :data:`QUANT_TILE`-sized
    tile, ``scale = amax / 127`` and ``q = round(x / scale)`` -- ~4x fewer
    bytes at ~``amax_tile / 127`` absolute error per element.  The f32
    scales are bitcast into extra int8 rows of the payload
    (:func:`q8_pack`), so an encoded block is one array.

Non-finite inputs are never masked: a tile holding NaN/Inf gets a
non-finite scale, so every decoded element of that tile is non-finite.
The codec applies to real float32/float64 payloads only.
"""
from __future__ import annotations

import torch

#: legal values of the ``comm_precision`` knob (``None`` = full precision)
COMM_PRECISIONS = (None, "bf16", "int8")

#: side of the square tiles the int8 scales are computed over
QUANT_TILE = 64


def check_comm_precision(mode) -> None:
    """Raise ValueError on an illegal ``comm_precision`` value."""
    if mode not in COMM_PRECISIONS:
        raise ValueError(
            f"comm_precision must be one of {COMM_PRECISIONS}, got {mode!r}")


def quantizable(dtype) -> bool:
    """True when the codec applies: real float32/float64 payloads."""
    return dtype in (torch.float32, torch.float64)


_RECIP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _tile_counts(shape, tile: int):
    lr, lc = shape[-2:]
    return -(-lr // tile), -(-lc // tile)


def _tiles(x, tile: int):
    """``x`` (..., lr, lc) zero-padded to whole tiles, as
    (..., tr, tile, tc, tile).  A dimension that fits in one tile is its
    own tile and is not padded: zero padding changes no tile's max |x|
    and is cut off again, so the codec gives the same bits, and a small
    block (a direct plan's slot) costs its own size, not a tile's."""
    lr, lc = x.shape[-2:]
    tr, tc = _tile_counts(x.shape, tile)
    hr = lr if tr == 1 else tile
    hc = lc if tc == 1 else tile
    xp = torch.nn.functional.pad(x, (0, tc * hc - lc, 0, tr * hr - lr))
    return xp.reshape(*x.shape[:-2], tr, hr, tc, hc)


def _untile(xb, shape):
    """Inverse of :func:`_tiles`: (..., tr, hr, tc, hc) back to
    (..., lr, lc)."""
    tr, hr, tc, hc = xb.shape[-4:]
    return xb.reshape(*xb.shape[:-4], tr * hr, tc * hc)[
        ..., :shape[-2], :shape[-1]]


def q8_encode(x, tile: int = QUANT_TILE, reciprocal: bool = False):
    """Block-scaled int8 quantization of a block (or a batch of blocks
    along the leading axes).

    Returns ``(q, scales)``: ``q`` int8 with ``x``'s shape, ``scales``
    float32 of shape ``(..., ceil(lr/tile), ceil(lc/tile))``.  Zero tiles
    get scale 1 (exact zeros round-trip); non-finite tiles a non-finite
    scale.  ``reciprocal=True`` forms the scale as ``amax * (1/127)``,
    one float32 rounding apart from ``amax / 127`` for some amax: XLA
    rewrites the division by the constant so inside the JAX engine's
    compiled programs, and the port's engine follows it to stay
    bit-equal (the JAX codec called op by op divides)."""
    xb = _tiles(x, tile)
    amax = xb.abs().amax(dim=(-3, -1)).to(torch.float32)
    # keep NaN/Inf amax (NaN == 0 is False): decode must not mask a tile
    amax = torch.where(amax == 0, torch.ones_like(amax), amax)
    scale = amax * _RECIP_127 if reciprocal else amax / 127.0
    q = torch.round(xb / scale[..., :, None, :, None].to(x.dtype))
    q = _untile(q.clamp(-127, 127).to(torch.int8), x.shape)
    return q, scale


def q8_decode(q, scales, dtype, tile: int = QUANT_TILE):
    """Inverse of :func:`q8_encode` (up to the documented error bound)."""
    qb = _tiles(q, tile).to(torch.float32)
    return _untile(qb * scales[..., :, None, :, None], q.shape).to(dtype)


def q8_packed_rows(shape, tile: int = QUANT_TILE) -> int:
    """Rows of a :func:`q8_pack` payload for a ``shape`` block."""
    lr, lc = shape
    tr, tc = _tile_counts(shape, tile)
    return lr + -(-tr * tc * 4 // lc)


def q8_pack(x, tile: int = QUANT_TILE):
    """Encode + pack one block into a single int8 array: the f32 scales
    bitcast to int8 and appended as whole extra rows below the payload."""
    lr, lc = x.shape
    q, scales = q8_encode(x, tile)
    sraw = scales.reshape(-1).contiguous().view(torch.int8)
    srows = -(-sraw.shape[0] // lc)
    sraw = torch.nn.functional.pad(sraw, (0, srows * lc - sraw.shape[0]))
    return torch.cat([q, sraw.reshape(srows, lc)], dim=0)


def q8_unpack(packed, shape, dtype, tile: int = QUANT_TILE):
    """Inverse of :func:`q8_pack`: split payload/scales, decode."""
    lr, lc = shape
    tr, tc = _tile_counts(shape, tile)
    q = packed[:lr]
    sraw = packed[lr:].reshape(-1)[: tr * tc * 4].clone()   # offset 0
    scales = sraw.view(torch.float32).reshape(tr, tc)
    return q8_decode(q, scales, dtype, tile)


def q8_roundtrip(x, tile: int = QUANT_TILE, reciprocal: bool = False):
    """``decode(encode(x))`` of every block along the leading axes: what a
    block sent over the int8 wire is on the far side (the bitcast packing
    of :func:`q8_pack` is lossless)."""
    q, scales = q8_encode(x, tile, reciprocal)
    return q8_decode(q, scales, x.dtype, tile)
