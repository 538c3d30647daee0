"""NumPy float winding oracle: the bit-exactness anchor.

A copy of ``fontrx/kernels/oracle.py``. Operation for operation with the
analytic CPU winding rasterizer, in IEEE float32:

- the quadratic is solved in y with the reduced discriminant
  ``delta = cy*a + p1y^2 - p0y*p2y``,
- the parameter interval is half-open, ``t in [0, 1)``,
- crossings strictly left of the sample (``xx < cx``) are excluded,
- the winding decrements where the curve ascends (``dy > 0``).

``contract`` picks how ``xx`` is evaluated: ``True`` fuses both
multiply-adds (what XLA:CPU emits), ``False`` rounds every operation (what
the TPU kernels, the port's plain versions and its CUDA kernels do).
``tests/test_torch_frontend.py`` holds it equal to the original.
"""

from __future__ import annotations

import numpy as np

from fontrx_torch.kernels.grid import RasterGrid

f32 = np.float32


def _fma(a, b, c):
    """IEEE-correct f32 fused multiply-add emulated through float64 (the
    f64 product of two f32 values is exact)."""
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    c64 = np.asarray(c, np.float64)
    return (a64 * b64 + c64).astype(f32)


def _poly_xx(ax, bx, p0x, t, contract: bool):
    """``xx = (ax*t + bx)*t + p0x``, fused or rounded step by step. The
    two differ by at most 1 ulp, which matters only for samples lying
    exactly on a curve."""
    if contract:
        return _fma(_fma(ax, t, bx), t, p0x)
    return (ax * t + bx) * t + p0x


def winding_at(segments: np.ndarray, cx, cy, contract: bool = True) -> np.ndarray:
    """Winding numbers of sample points against quadratic segments.

    ``segments``: float32 ``[S, 3, 2]``; ``cx``/``cy``: broadcastable
    float32 sample coordinates. Returns int32 winding with shape
    ``broadcast(cx, cy)``. Zero-padded segments contribute nothing.
    """
    seg = np.asarray(segments, dtype=f32)
    cx = np.asarray(cx, dtype=f32)
    cy = np.asarray(cy, dtype=f32)
    out_shape = np.broadcast_shapes(cx.shape, cy.shape)

    # chunk the segment axis to bound temporaries; integer winding sums are
    # order-independent, so per-element results are unchanged
    chunk = 16
    if len(seg) > chunk:
        total = np.zeros(out_shape, dtype=np.int32)
        for s0 in range(0, len(seg), chunk):
            total += winding_at(seg[s0 : s0 + chunk], cx, cy, contract)
        return total

    p0x, p0y = seg[:, 0, 0], seg[:, 0, 1]
    p1x, p1y = seg[:, 1, 0], seg[:, 1, 1]
    p2x, p2y = seg[:, 2, 0], seg[:, 2, 1]

    cx = np.broadcast_to(cx, out_shape)[..., None]  # [..., 1] vs segment axis
    cy = np.broadcast_to(cy, out_shape)[..., None]

    a = p0y - 2 * p1y + p2y  # [S]
    ax = p0x - 2 * p1x + p2x
    bx = 2 * (p1x - p0x)

    winding = np.zeros(out_shape, dtype=np.int32)

    with np.errstate(divide="ignore", invalid="ignore"):
        # --- degenerate (linear in y) branch
        lin = a == 0
        nonflat = lin & (p2y != p0y)
        t = (cy - p0y) / (p2y - p0y)
        valid = nonflat & (t >= 0) & (t < 1)
        xx = _poly_xx(ax, bx, p0x, t, contract)
        valid &= ~(xx < cx)
        sign = np.where(p0y < p2y, -1, 1).astype(np.int32)
        winding += np.sum(np.where(valid, sign, 0), axis=-1, dtype=np.int32)

        # --- quadratic branch
        quad = ~lin
        delta = cy * a + p1y * p1y - p0y * p2y
        has_roots = quad & (delta >= 0)
        sq = np.sqrt(np.where(delta >= 0, delta, f32(0)))
        for sgn in (f32(1), f32(-1)):
            troot = ((p0y - p1y) + sgn * sq) / a
            valid = has_roots & (troot >= 0) & (troot < 1)
            xx = _poly_xx(ax, bx, p0x, troot, contract)
            valid &= ~(xx < cx)
            dy = a * troot + (p1y - p0y)
            contrib = np.where(dy > 0, -1, 1).astype(np.int32)
            winding += np.sum(np.where(valid, contrib, 0), axis=-1, dtype=np.int32)

    return winding


def winding_map(
    segments: np.ndarray, grid: RasterGrid, contract: bool = True
) -> np.ndarray:
    """Full winding map over a grid: int32 ``[H, W]``, row 0 at the top."""
    xs, ys = grid.sample_coords()
    return winding_at(segments, cx=xs[None, :], cy=ys[:, None], contract=contract)


def render_gray(segments: np.ndarray, grid: RasterGrid) -> np.ndarray:
    """The winding visualization ``clamp(w*20+100, 0, 255)``, uint8 ``[H, W]``."""
    w = winding_map(segments, grid)
    return np.clip(w * 20 + 100, 0, 255).astype(np.uint8)


def render_fill(segments: np.ndarray, grid: RasterGrid) -> np.ndarray:
    """Nonzero-winding fill, uint8 ``[H, W]`` of 0/255."""
    w = winding_map(segments, grid)
    return np.where(w != 0, 255, 0).astype(np.uint8)
