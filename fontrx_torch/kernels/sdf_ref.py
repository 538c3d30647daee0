"""Plain PyTorch signed distance fields: the reference for the CUDA SDF
kernel.

The port of what the TPU's SDF kernels compute (K10
``fontrx/kernels/sdf_pallas.py::_make_sdf_kernel``, and K11, which gives the
same result from per-tile segment lists): the float program of the Pallas
kernel, not of the jnp fallback ``fontrx/kernels/sdf.py`` (8 starts x 4
iterations, no clamp).

Per glyph and pixel ``(row r, column c)`` the sample lies at em-space
``px = f32(min_x + c) / scale``, ``py = f32(max_y - r) / scale``. Per live
segment and pixel, the squared distance to the quadratic is the least of
``dist_sq(0)``, ``dist_sq(1)`` and ``dist_sq(refine(t0))`` for the
``NEWTON_STARTS`` start values ``t0 = f32((2s + 1) / (2 NEWTON_STARTS))``,
where ``refine`` runs ``NEWTON_ITERS`` clamped Newton steps on the
stationary cubic (the Pallas kernel's defaults, 3 and 3). An
all-zero segment is padding: its distance is ``inf``. Then
``sign * min(sqrt(d2) * scale, spread)``, with the sign ``+1`` where the
nonzero winding is not 0 and ``-1`` elsewhere.

Eager PyTorch rounds every operation on its own, in the association the
Pallas kernel writes, so this is the strict float32 program: no
``addcmul``, no ``torch.compile``. Every divisor is a tensor on the data's
device and the square root is ``winding_ref.sqrt_rn`` (see
``winding_ref``). ``torch.minimum`` and ``torch.clamp`` propagate NaN, as
``jnp.minimum`` and ``jnp.clip`` do. This version culls nothing: every
(segment, pixel) pair is computed.
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch.kernels import winding_ref

NEWTON_STARTS = 3  # sdf_pallas.py:42-43
NEWTON_ITERS = 3
SPREAD_PX = 8.0

# bytes of live temporaries per (glyph, segment, pixel) element of a chunk:
# about a dozen float32 terms of the Newton program at a time
_BYTES_PER_ELEMENT = 64
_CHUNK_BUDGET = 1 << 30


# the Python floats (2s + 1) / (2 starts) rounded to float32, as
# jnp.full_like rounds them (sdf_pallas.py:154)
START_VALUES = [np.float32((2 * s + 1) / (2 * NEWTON_STARTS)) for s in range(NEWTON_STARTS)]


def _pair_dist_sq(seg, px, py):
    """Least squared distance of each segment to each sample point.

    ``seg`` float32 ``[B, C, 1, 1, 3, 2]``, ``px`` ``[B, 1, 1, W]``, ``py``
    ``[B, 1, H, 1]`` -> ``[B, C, H, W]``, ``inf`` for all-zero segments.
    """
    p0x, p0y = seg[..., 0, 0], seg[..., 0, 1]
    p1x, p1y = seg[..., 1, 0], seg[..., 1, 1]
    p2x, p2y = seg[..., 2, 0], seg[..., 2, 1]

    ax = p1x - p0x
    ay = p1y - p0y
    bx2 = p0x - 2 * p1x + p2x
    by2 = p0y - 2 * p1y + p2y
    k3 = bx2 * bx2 + by2 * by2
    k2 = 3 * (ax * bx2 + ay * by2)
    k1 = 2 * (ax * ax + ay * ay)
    k3x3 = 3 * k3
    k2x2 = 2 * k2

    qx = p0x - px  # [B, C, 1, W]
    qy = p0y - py  # [B, C, H, 1]
    qa = qx * ax + qy * ay
    qb = qx * bx2 + qy * by2
    k1b = k1 + qb

    def dist_sq(t):
        t2 = 2 * t
        tt = t * t
        dx = qx + t2 * ax + tt * bx2
        dy = qy + t2 * ay + tt * by2
        return dx * dx + dy * dy

    def refine(t):
        for _ in range(NEWTON_ITERS):
            f = ((k3 * t + k2) * t + k1b) * t + qa
            df = (k3x3 * t + k2x2) * t + k1b
            df = torch.where(df == 0, one, df)
            t = torch.clamp(t - f / df, 0.0, 1.0)
        return t

    dev = seg.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    best = dist_sq(torch.zeros((), dtype=torch.float32, device=dev))
    best = torch.minimum(best, dist_sq(one))
    for t0 in START_VALUES:
        t = torch.full(k1b.shape, float(t0), dtype=torch.float32, device=dev)
        best = torch.minimum(best, dist_sq(refine(t)))
    dead = (seg == 0).flatten(-2).all(dim=-1)  # [B, C, 1, 1]
    return torch.where(dead, torch.inf, best)


def seg_chunk(batch: int, height: int, width: int) -> int:
    """Segments per chunk, so that one chunk's temporaries stay within the
    budget."""
    per_segment = max(batch * height * width * _BYTES_PER_ELEMENT, 1)
    return max(1, _CHUNK_BUDGET // per_segment)


def min_dist_sq(segments, min_x, max_y, scale, *, height, width):
    """Least squared em-space distance from each pixel's sample point to the
    glyph's live segments: float32 ``[B, height, width]``, ``inf`` where a
    glyph has none.

    ``segments`` float32 ``[B, S, 3, 2]`` (zero rows are padding),
    ``min_x``/``max_y`` int32 ``[B]``, ``scale`` a host number rounded to
    float32.
    """
    b, s = segments.shape[:2]
    px, py = winding_ref.sample_coords(min_x, max_y, scale, height=height, width=width)
    pxb = px[:, None, None, :]  # [B, 1, 1, W]
    pyb = py[:, None, :, None]  # [B, 1, H, 1]
    out = torch.full((b, height, width), torch.inf, dtype=torch.float32,
                     device=segments.device)
    step = seg_chunk(b, height, width)
    for s0 in range(0, s, step):
        chunk = segments[:, s0 : s0 + step, None, None]  # [B, C, 1, 1, 3, 2]
        d2 = _pair_dist_sq(chunk, pxb, pyb)
        out = torch.minimum(out, d2.amin(dim=1))
    return out


def sdf_from_winding(segments, min_x, max_y, scale, winding, *, height, width,
                     spread_px=SPREAD_PX):
    """Signed distances in pixels from the distances and a winding map:
    ``sign * min(sqrt(d2) * scale, spread)``, float32 ``[B, H, W]``,
    positive inside (``winding != 0``)."""
    dev = segments.device
    d2 = min_dist_sq(segments, min_x, max_y, scale, height=height, width=width)
    scale_t = torch.tensor(np.float32(scale), device=dev)
    spread_t = torch.tensor(np.float32(spread_px), device=dev)
    dist = torch.minimum(winding_ref.sqrt_rn(d2) * scale_t, spread_t)
    plus = torch.ones((), dtype=torch.float32, device=dev)
    sign = torch.where(winding != 0, plus, -plus)
    return sign * dist


def sdf_batch(segments, min_x, max_y, scale, *, height, width, spread_px=SPREAD_PX):
    """Batched signed distance fields: float32 ``[B, height, width]`` in
    pixels, positive inside, clamped at ``+-spread_px``. The sign comes
    from ``winding_ref.winding_batch``. Same arguments as
    ``winding_ref.winding_batch``."""
    w = winding_ref.winding_batch(segments, min_x, max_y, scale, height=height, width=width)
    return sdf_from_winding(segments, min_x, max_y, scale, w, height=height, width=width,
                            spread_px=spread_px)


def sdf_to_u8(sdf: torch.Tensor, spread: float = SPREAD_PX) -> torch.Tensor:
    """The 8-bit atlas encoding: 128 at the outline, ``+-spread`` px at 255
    and 0. ``clip(round_half_even(128 + sdf * f32(127 / spread)), 0, 255)``
    (``fontrx/kernels/sdf.py:107-112``)."""
    k = torch.tensor(np.float32(127.0 / spread), device=sdf.device)
    return torch.clamp(torch.round(128.0 + sdf * k), 0, 255).to(torch.uint8)
