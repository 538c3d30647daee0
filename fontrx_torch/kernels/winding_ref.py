"""Plain PyTorch winding fill: the reference for the CUDA winding kernel.

The port of ``fontrx.kernels.winding_jnp``: the same float32 program as
``fontrx.kernels.oracle.winding_at``, in the same operation order. Eager
PyTorch rounds every operation on its own, so this follows the oracle's
``contract=False`` mode exactly. Nothing here may be fused: no ``addcmul``,
no ``torch.compile``.

Three rules keep it exact on both devices:

- every divisor is a tensor on the data's device. PyTorch's CUDA division
  by a CPU scalar multiplies by the reciprocal, which is not correctly
  rounded;
- the square root is ``sqrt_rn``. ``torch.sqrt`` on the CPU is not
  correctly rounded: it misses by an ulp on about 0.7% of float32 inputs,
  and in some processes by ten ulps and more on a share of them;
- segments broadcast against ``cy [.., H, 1]`` and ``cx [.., 1, W]``, so the
  root solve runs per (segment, row) and only the ``xx < cx`` test runs per
  pixel, as in the oracle.
"""

from __future__ import annotations

import numpy as np
import torch

# bytes of live per-pixel temporaries per (glyph, segment, pixel) element of
# a chunk: a few bool masks and int32 terms at a time
_BYTES_PER_ELEMENT = 16
# per-chunk budget: about 1 GiB of temporaries, so 94 glyphs x 256 x 256 px
# stays under 2 GB at peak
_CHUNK_BUDGET = 1 << 30


def sqrt_rn(x):
    """Correctly rounded float32 square root of ``x >= 0``.

    On the CPU it is NumPy's, which rounds to nearest as IEEE 754 asks.
    ``torch.sqrt`` there is not: besides its one-ulp misses, a run of it
    can return values up to 3.2e-4 off (more than ten ulps) on thousands of
    elements, in some processes and not in others, so no correction of its
    result can be trusted. On CUDA ``torch.sqrt`` gives a value within an
    ulp; one exact float64 test against each neighbouring float32 midpoint
    rounds it to nearest. A midpoint has 25 significant bits, so its square
    is exact in float64, and no float32 input lies on a midpoint's square,
    so there is no tie.
    """
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    s = torch.sqrt(x)
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    down = torch.nextafter(s, torch.zeros_like(s))
    x64, s64 = x.double(), s.double()
    hi = (s64 + up.double()) * 0.5
    lo = (s64 + down.double()) * 0.5
    s = torch.where(x64 > hi * hi, up, s)
    return torch.where(x64 < lo * lo, down, s)


def winding_contrib(seg, cx, cy):
    """Winding contributions of segments against sample points.

    ``seg``: float32 ``[..., 3, 2]``, broadcastable against ``cx``/``cy``;
    returns the int32 contribution of each segment (the caller reduces).
    Operation for operation with ``oracle.winding_at(contract=False)``:
    degenerate branch, reduced discriminant and two roots, half-open
    ``t in [0, 1)``, ``xx < cx`` exclusion, sign from ``dy > 0``.
    """
    p0x, p0y = seg[..., 0, 0], seg[..., 0, 1]
    p1x, p1y = seg[..., 1, 0], seg[..., 1, 1]
    p2x, p2y = seg[..., 2, 0], seg[..., 2, 1]

    a = p0y - 2 * p1y + p2y
    ax = p0x - 2 * p1x + p2x
    bx = 2 * (p1x - p0x)

    # degenerate (linear in y)
    lin = a == 0
    denom = p2y - p0y
    t_lin = (cy - p0y) / denom
    xx_lin = (ax * t_lin + bx) * t_lin + p0x
    row_lin = lin & (denom != 0) & (t_lin >= 0) & (t_lin < 1)
    sign_lin = torch.where(p0y < p2y, -1, 1).to(torch.int32)
    w = torch.where(row_lin & ~(xx_lin < cx), sign_lin, 0)

    # quadratic: two roots
    delta = cy * a + p1y * p1y - p0y * p2y
    has_roots = ~lin & (delta >= 0)
    sq = sqrt_rn(torch.where(delta >= 0, delta, 0.0))
    py01 = p0y - p1y
    for t in ((py01 + sq) / a, (py01 - sq) / a):
        xx = (ax * t + bx) * t + p0x
        row_ok = has_roots & (t >= 0) & (t < 1)
        dy = a * t + (p1y - p0y)
        contrib = torch.where(dy > 0, -1, 1).to(torch.int32)
        w = w + torch.where(row_ok & ~(xx < cx), contrib, 0)
    return w


def sample_coords(min_x, max_y, scale, *, height, width, sample_offset=(0.0, 0.0)):
    """Em-space sample coordinates ``cx [B, W]`` and ``cy [B, H]``: an
    integer add first, then one float32 divide (``grid.py:95-102``)."""
    dev = min_x.device
    scale = torch.tensor(scale, dtype=torch.float32, device=dev)
    ox = torch.tensor(sample_offset[0], dtype=torch.float32, device=dev)
    oy = torch.tensor(sample_offset[1], dtype=torch.float32, device=dev)
    cols = torch.arange(width, dtype=torch.int32, device=dev)
    rows = torch.arange(height, dtype=torch.int32, device=dev)
    xi = (min_x[:, None] + cols).to(torch.float32)
    yi = (max_y[:, None] - rows).to(torch.float32)
    return (xi + ox) / scale, (yi + oy) / scale


def seg_chunk(batch: int, height: int, width: int) -> int:
    """Segments per chunk, so that one chunk's per-pixel temporaries stay
    within the budget."""
    per_segment = max(batch * height * width * _BYTES_PER_ELEMENT, 1)
    return max(1, _CHUNK_BUDGET // per_segment)


def winding_batch(
    segments, min_x, max_y, scale, *, height, width, sample_offset=(0.0, 0.0)
):
    """Batched winding maps with per-glyph grid anchors.

    - ``segments``: float32 ``[B, S, 3, 2]`` (zero-padded; padding is inert)
    - ``min_x``, ``max_y``: int32 ``[B]`` pixel-space anchors
    - ``scale``: pixels per font unit, rounded to float32
    - ``sample_offset``: ``(ox, oy)`` sub-pixel offsets in pixels
    -> int32 ``[B, height, width]`` on the segments' device, row 0 at the top.
    """
    b, s = segments.shape[:2]
    cx, cy = sample_coords(
        min_x, max_y, scale, height=height, width=width,
        sample_offset=sample_offset,
    )
    cxb = cx[:, None, None, :]  # [B, 1, 1, W]
    cyb = cy[:, None, :, None]  # [B, 1, H, 1]
    out = torch.zeros((b, height, width), dtype=torch.int32, device=segments.device)
    step = seg_chunk(b, height, width)
    for s0 in range(0, s, step):
        chunk = segments[:, s0 : s0 + step, None, None]  # [B, C, 1, 1, 3, 2]
        out += winding_contrib(chunk, cxb, cyb).sum(dim=1, dtype=torch.int32)
    return out


def winding_windows_batch(
    segments_win, counts, min_x, max_y, scale, *, height, width, win_rows,
    sample_offset=(0.0, 0.0),
):
    """Winding maps from a window-major stream (``pack.windows``): the
    function of K3, ``winding_dense.py::winding_dense_win_batch``.

    - ``segments_win``: float32 ``[B, n_windows * cap, 3, 2]``
    - ``counts``: int32 ``[B, n_windows]``, the live copies of each window
    - ``min_x``, ``max_y``: int32 ``[B]``; ``scale`` and ``sample_offset``
      as in ``winding_batch``
    -> int32 ``[B, height, width]``.

    Window ``w``'s first ``counts[b, w]`` copies are solved on its rows
    ``[w * win_rows, (w + 1) * win_rows)`` that lie below ``height`` and on
    no other row. A root that the float program finds on a row outside a
    segment's windows is therefore dropped, as K3 drops it.
    """
    b, n_windows = counts.shape
    cap = segments_win.shape[1] // max(n_windows, 1)
    cx, cy = sample_coords(
        min_x, max_y, scale, height=height, width=width, sample_offset=sample_offset,
    )
    cxb = cx[:, None, None, :]  # [B, 1, 1, W]
    out = torch.zeros((b, height, width), dtype=torch.int32, device=segments_win.device)
    slot = torch.arange(cap, device=segments_win.device)
    for w in range(n_windows):
        r0, r1 = w * win_rows, min((w + 1) * win_rows, height)
        if r0 >= r1:
            continue
        n = int(counts[:, w].max()) if b else 0
        live = slot[:n][None, :] < counts[:, w, None]  # [B, n]
        segs = torch.where(live[..., None, None], segments_win[:, w * cap : w * cap + n], 0.0)
        cyb = cy[:, None, r0:r1, None]  # [B, 1, R, 1]
        step = seg_chunk(b, r1 - r0, width)
        for s0 in range(0, n, step):
            chunk = segs[:, s0 : s0 + step, None, None]  # [B, C, 1, 1, 3, 2]
            out[:, r0:r1] += winding_contrib(chunk, cxb, cyb).sum(dim=1, dtype=torch.int32)
    return out


# rows of a banded element's strip (K5/K6's STRIP_ROWS)
STRIP_ROWS = 128


def winding_banded_batch(
    segments, owners, min_x, max_y, scale, *, width, sample_offset=(0.0, 0.0)
):
    """Row-banded strips: the function of K5 and K6,
    ``winding_pallas_v2.py::winding_pallas_banded_batch`` and
    ``winding_dense.py::winding_dense_banded_batch``.

    - ``segments``: float32 ``[B, S, 3, 2]``, each element's bands' segments
      in any order
    - ``owners``: int32 ``[B, S]``, the band of each segment
    - ``min_x``, ``max_y``: int32 ``[R, B]``, each band's anchors; ``R``
      divides 128
    - ``scale`` and ``sample_offset`` as in ``winding_batch``
    -> int32 ``[B, 128, width]``.

    Rows ``[k * 128/R, (k + 1) * 128/R)`` of element ``b`` are
    ``winding_batch``'s map at ``(min_x[k, b], max_y[k, b])`` over the
    segments whose owner is ``k``: every other segment's crossings are
    masked to zero there, as the TPU kernels mask them (an owner outside
    ``[0, R)`` adds nothing anywhere).
    """
    r, b = min_x.shape
    band_h = STRIP_ROWS // r
    s = segments.shape[1]
    out = torch.zeros((b, STRIP_ROWS, width), dtype=torch.int32, device=segments.device)
    step = seg_chunk(b, band_h, width)
    for k in range(r):
        cx, cy = sample_coords(min_x[k], max_y[k], scale, height=band_h, width=width,
                               sample_offset=sample_offset)
        cxb = cx[:, None, None, :]  # [B, 1, 1, W]
        cyb = cy[:, None, :, None]  # [B, 1, H, 1]
        mine = (owners == k)[:, :, None, None]  # [B, S, 1, 1]
        rows = out[:, k * band_h : (k + 1) * band_h]
        for s0 in range(0, s, step):
            chunk = segments[:, s0 : s0 + step, None, None]  # [B, C, 1, 1, 3, 2]
            contrib = winding_contrib(chunk, cxb, cyb)
            rows += torch.where(mine[:, s0 : s0 + step], contrib, 0).sum(dim=1, dtype=torch.int32)
    return out
