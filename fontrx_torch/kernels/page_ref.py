"""Plain PyTorch direct page render: the reference for the CUDA page kernel.

The port of ``fontrx/scene/page.py::_direct_page_step`` (lines 153-253):
every instance's live em-space segments go to page pixels (y up) with
one rounding, ``fma(flat_segments, s_px, offset)``, and the page is the
winding of that one stream as the reference's two TPU kernels compute it:
K7 (``winding_page.py:53-264``) for padded widths of 1024 px and more, the
v2 carry sweep (``winding_pallas_v2.py:131-520``) below that. Row ``r``
samples ``y = page_h - 1 - band_y0 - r`` and column ``c`` samples ``x = c``;
each (segment, row) pair gets the float program of ``phase_a_roots``
(``crossings``), exactly as ``winding_ref.winding_batch`` at batch 1 with
anchors ``(0, page_h - 1 - band_y0)`` and scale 1.

Both TPU kernels cull by chunks of consecutive segments, and that cull is
part of the function. A quadratic that is nearly a line (an em-space line
after a rounded zoom) gets a tiny ``a``, its discriminant cancels, and the
float program gives it roots on rows far from its hull. Such a stray
crossing counts only where the kernels solve the pair, so the page is:

- per 128-row strip of the band and chunk of ``C`` segments (16 on the v2
  route, 32 on K7's), every pair is solved when the chunk's control hull,
  widened by 1 px, meets the strip's rows, and none otherwise;
- a crossing at ``xx`` in column tile ``t`` (``tw`` columns: 128, or 256 on
  K7's route when the padded width allows) adds its sign to every column of
  the tiles left of ``t``, and to the columns ``c <= xx`` of tile ``t`` only
  when the chunk's widened hull meets the row's 16-row window; one right of
  the padded width adds to every column;
- on K7's route a chunk whose widened x-hull ends left of column 0 is
  skipped, a crossing counts only in the tiles within 2 px of that x-hull
  (``winding_page.py:222-238``), and one right of the padded width only when
  the x-hull reaches it;
- the reference pads the stream to a multiple of 2048 with segments at the
  point ``(-1e7, -1e7)``, so a last chunk that is not full has that point
  in its hull.

On a page without strays (the first view, whose transform is exact) this
equals the winding of every pair, as ``csrc/winding.cu`` computes it.

Nothing here runs on the card's path; the tests and ``chip_smoke.py``
compare the kernel with it.
"""

from __future__ import annotations

import torch

from fontrx_torch.kernels import winding_ref

# the output modes: the int32 winding, the 0/255 fill, and the debug gray
# of the reference's mode="winding" (page.py:220-223)
MODES = ("winding", "fill", "gray")

STRIP_ROWS = 128
WINDOW_ROWS = 16
# the point of the reference's padding segments: all-zero em-space
# segments owned by an instance at (-1e7, -1e7) (page.py:445-451, :541-553)
PAD_POINT = -1e7

# unit roundoff of float32
U = 2.0 ** -24
# segments solved at once on a strip: their [2, S, 128] temporaries stay
# within a few hundred MB
_SEGMENTS_PER_STEP = 1 << 15


def route(page_w: int) -> tuple[int, int, bool]:
    """``(chunk, tile_w, x_cull)`` of the reference's route for a page
    ``page_w`` wide: K7 from a padded width of 1024 (``page.py:190-214``),
    else the v2 carry sweep with ``PAGE_TUNING`` (``page.py:150``)."""
    pw = padded_width(page_w)
    if pw >= 1024:
        return 32, 256 if pw % 256 == 0 else 128, True
    return 16, 128, False


def padded_width(page_w: int) -> int:
    return (page_w + 127) // 128 * 128


def fma_rn(a, b, c):
    """``a * b + c`` for float32 tensors with one rounding to nearest, as a
    fused multiply-add gives it. ``a * b`` is exact in float64; the float64
    sum is rounded to odd (its exact error from TwoSum decides the last
    bit), so the one rounding to float32 after it is the correct one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def transform_segments(flat_segments, seg_inst_idx, inst_offsets, s_px):
    """Em-space segments float32 ``[S, 3, 2]`` to page pixels: each point
    times ``s_px`` plus its instance's float32 ``[N, 2]`` offset, rounded
    once. The reference writes ``flat_segments * s_px + offs``
    (``page.py:183-184``), and XLA compiles that to a fused multiply-add: at
    a view whose ``s_px`` has many bits, two roundings give other points."""
    s = torch.tensor(s_px, dtype=torch.float32, device=flat_segments.device)
    offs = inst_offsets[seg_inst_idx.long()]
    return fma_rn(flat_segments, s, offs[:, None, :])


def chunk_hulls(q, chunk: int):
    """Per chunk of ``chunk`` consecutive page-space segments ``q`` float32
    ``[S, 6]``, its control hull: float32 ``[n, 4]`` of ``(y_min, y_max,
    x_min, x_max)``, a last chunk that is not full with ``PAD_POINT``."""
    n = -(-len(q) // chunk)
    pad = torch.full((n * chunk - len(q), 6), PAD_POINT, dtype=q.dtype, device=q.device)
    qc = torch.cat([q, pad]).reshape(n, chunk * 3, 2)
    return torch.stack([qc[..., 1].amin(1), qc[..., 1].amax(1), qc[..., 0].amin(1),
                        qc[..., 0].amax(1)], dim=1)


def meets(hull, y_hi, y_lo):
    """Bool: a hull ``[.., 4]`` widened by 1 px meets the rows from ``y_hi``
    down to ``y_lo``, in float32 as the TPU kernels test it."""
    return (hull[..., 1] + 1.0 >= y_lo) & (hull[..., 0] - 1.0 <= y_hi)


def tile_range(hull, tile_w: int):
    """K7's column tiles of a chunk (``winding_page.py:225-236``): float32
    ``(t_lo, t_hi)`` from its x-hull widened by 1 px, then 2 px."""
    lo = ((hull[..., 2] - 1.0) - 2.0) / tile_w
    hi = ((hull[..., 3] + 1.0) + 2.0) / tile_w
    return torch.floor(lo), torch.floor(hi)


def crossings(q, cy):
    """The float program of ``phase_a_roots`` (``crossings.cuh``) per
    (segment, row): ``(xx, sign, live)``, float32 and int32 ``[2, S, R]``,
    one slot for the line's or the first root, one for the second, a dead
    slot with sign 0; and bool ``[S, R]``, where a quadratic's discriminant
    is >= 0. ``q`` float32 ``[S, 6]``, ``cy`` float32 ``[R]``."""
    p0x, p0y, p1x, p1y, p2x, p2y = (q[:, i : i + 1] for i in range(6))
    y = cy[None, :]
    a = p0y - 2 * p1y + p2y
    ax = p0x - 2 * p1x + p2x
    bx = 2 * (p1x - p0x)
    lin = a == 0
    denom = p2y - p0y
    delta = y * a + p1y * p1y - p0y * p2y
    live = ~lin & (delta >= 0)
    sq = winding_ref.sqrt_rn(torch.where(delta >= 0, delta, 0.0))
    py01 = p0y - p1y
    t0 = torch.where(lin, (y - p0y) / denom, (py01 + sq) / a)
    t1 = (py01 - sq) / a
    ok0 = torch.where(lin, denom != 0, live) & (t0 >= 0) & (t0 < 1)
    ok1 = live & (t1 >= 0) & (t1 < 1)
    xs, signs = [], []
    for t, ok in ((t0, ok0), (t1, ok1)):
        xs.append((ax * t + bx) * t + p0x)
        dy = a * t + (p1y - p0y)
        sign = torch.where(dy > 0, -1, 1)
        signs.append(torch.where(ok, sign, 0).to(torch.int32))
    signs[0] = torch.where(lin & ok0, torch.where(p0y < p2y, -1, 1), signs[0]).to(torch.int32)
    return torch.stack(xs), torch.stack(signs), live


def finish(winding, mode: str):
    """The int32 winding as the page ``mode`` asks: itself, the 0/255 fill,
    or the debug gray ``clip(w * 20 + 100, 0, 255)``, both uint8."""
    if mode == "winding":
        return winding
    if mode == "fill":
        return torch.where(winding != 0, 255, 0).to(torch.uint8)
    if mode == "gray":
        return torch.clamp(winding * 20 + 100, 0, 255).to(torch.uint8)
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def strip_chunks(hulls, top: int, strip: int, x_cull: bool):
    """Bool ``[n]``: the chunks the TPU kernels solve on strip ``strip`` of a
    band whose row 0 samples ``y = top``."""
    y_hi = float(top - strip * STRIP_ROWS)
    ok = meets(hulls, y_hi, y_hi - (STRIP_ROWS - 1))
    if x_cull:
        ok &= hulls[:, 3] + 1.0 >= 0.0
    return ok


def deposits(q, hulls, seg_chunk, cy, rows, *, page_w: int):
    """Where each crossing of segments ``q`` (float32 ``[S, 6]``, chunk
    index ``seg_chunk`` int64 ``[S]``) on sample rows ``cy`` lands: ``(k,
    sign)``, int64 and int32 ``[2, S, R]``, the crossing adding ``sign`` to
    columns ``[0, k)`` of its row. ``rows`` int64 ``[R]`` are the rows'
    indices in the band, which place their 16-row windows."""
    chunk, tile_w, x_cull = route(page_w)
    pw = padded_width(page_w)
    dev = q.device
    xx, sign, _ = crossings(q, cy)
    cx = torch.arange(pw, device=dev).to(torch.float32)
    k = torch.searchsorted(cx, xx.reshape(-1), right=True).reshape(xx.shape)
    tile = torch.div(k - 1, tile_w, rounding_mode="floor")
    h = hulls[seg_chunk][:, None, :]  # [S, 1, 4]
    w_hi = cy[0] - (rows - rows[0]) + rows % WINDOW_ROWS  # each row's window top
    window = meets(h, w_hi[None, :], (w_hi - (WINDOW_ROWS - 1))[None, :])
    k = torch.where(window[None], k, tile * tile_w)
    right = xx >= float(pw)
    if x_cull:
        t_lo, t_hi = tile_range(h, tile_w)
        visited = (tile >= t_lo[None]) & (tile <= t_hi[None])
        k = torch.where(visited, k, 0)
        k = torch.where(right, torch.where(h[None, ..., 3] + 1.0 >= float(pw), pw, 0), k)
    else:
        k = torch.where(right, pw, k)
    return torch.clamp(k, 0, page_w), sign


def direct_page(flat_segments, seg_inst_idx, inst_offsets, s_px, band_y0=0, *, page_h, page_w,
                out_h=None, mode="fill"):
    """Rows ``[band_y0, band_y0 + out_h)`` of the page (all of it by
    default): ``[out_h, page_w]``, int32 for ``mode="winding"``, else uint8.

    - ``flat_segments``: float32 ``[S, 3, 2]`` em-space segments, every
      instance's live segments concatenated
    - ``seg_inst_idx``: int32 ``[S]`` owning instance per segment
    - ``inst_offsets``: float32 ``[N, 2]`` page-pixel offset of each
      instance's em origin, y up
    - ``s_px``: pixels per font unit, rounded to float32
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    oh = page_h if out_h is None else out_h
    dev = flat_segments.device
    top = page_h - 1 - band_y0
    q = transform_segments(flat_segments, seg_inst_idx, inst_offsets, s_px).reshape(-1, 6)
    chunk, _, x_cull = route(page_w)
    bucket = torch.zeros((oh, page_w + 1), dtype=torch.int32, device=dev)
    if len(q):
        hulls = chunk_hulls(q, chunk)
        seg_chunk = torch.arange(len(q), device=dev) // chunk
        for strip in range(-(-oh // STRIP_ROWS)):
            live = strip_chunks(hulls, top, strip, x_cull)[seg_chunk]
            if not bool(live.any()):
                continue
            r0, r1 = strip * STRIP_ROWS, min(oh, (strip + 1) * STRIP_ROWS)
            rows = torch.arange(r0, r1, device=dev)
            cy = row_coords(top - r0, r1 - r0, dev)
            live_segs = torch.nonzero(live)[:, 0]
            for s0 in range(0, len(live_segs), _SEGMENTS_PER_STEP):
                segs = live_segs[s0 : s0 + _SEGMENTS_PER_STEP]
                k, sign = deposits(q[segs], hulls, seg_chunk[segs], cy, rows, page_w=page_w)
                row = rows[None, None, :].expand_as(k) - r0
                bucket[r0:r1].index_put_((row.reshape(-1), k.reshape(-1)), sign.reshape(-1),
                                         accumulate=True)
    winding = bucket[:, 1:].flip(1).cumsum(1, dtype=torch.int32).flip(1)
    return finish(winding, mode)


def row_coords(top: int, rows: int, device=None):
    """Sample y of rows ``0 .. rows-1`` below a row 0 at ``top``: float32
    ``top - r``, as ``winding_ref.sample_coords`` at scale 1."""
    return (top - torch.arange(rows, dtype=torch.int32, device=device)).to(torch.float32)


def row_roots(q, cy):
    """Crossings per (segment, row), int32 ``[S, R]``, and where a
    quadratic's discriminant is >= 0, bool ``[S, R]``."""
    _, sign, live = crossings(q, cy)
    return (sign != 0).sum(0, dtype=torch.int32), live


def strip_table(q, top: int, rows: int, page_w: int):
    """Bool ``[S, strips]``: the 128-row strips of a band of ``rows`` rows
    (row 0 at ``y = top``) on which the page solves each segment, those its
    chunk meets."""
    chunk, _, x_cull = route(page_w)
    n = -(-rows // STRIP_ROWS)
    if not len(q):
        return torch.zeros((0, n), dtype=torch.bool, device=q.device)
    hulls = chunk_hulls(q, chunk)
    seg_chunk = torch.arange(len(q), device=q.device) // chunk
    return torch.stack([strip_chunks(hulls, top, i, x_cull)[seg_chunk] for i in range(n)], 1)


def solved_rows(q, top: int, rows: int, page_w: int):
    """Bool ``[S, rows]``: the (segment, row) pairs the page solves."""
    row_strip = torch.arange(rows, device=q.device) // STRIP_ROWS
    return strip_table(q, top, rows, page_w)[:, row_strip]


def margin(q, ymax):
    """Per page-space segment ``q`` float32 ``[S, 6]``, the distance in
    pixels beyond its control hull's y-range within which the float program
    of ``crossings.cuh`` can still place a crossing, over rows whose
    ``|y| <= ymax``: float64 ``[S]``.

    - A line (``a == 0``): 1. Its ``t = (y - p0y) / (p2y - p0y)`` is
      monotone in ``y`` as rounded, so a row outside the hull gets
      ``t < 0`` or ``t >= 1``, or ``-0`` from an underflow on a row less
      than 2^-19 px off the hull.
    - A quadratic: ``max(1, 160 M^2 u / (|a| - 8 M u) + 32 M u)``, ``u`` the
      unit roundoff of float32 and ``M >= 1`` the largest of the row and
      coordinate magnitudes; infinite where ``|a| <= 8 M u``. Any root of
      the program in ``[0, 1)`` lies on a row within this distance of the
      curve, which lies in its hull: the derivation is in
      ``csrc/page.cu``. A quadratic that is nearly a line has a tiny ``a``
      after the rounded transform, its discriminant cancels, and its
      rounded roots stray far; such segments visit every row their chunk's
      strips hold.
    """
    p0y, p1y, p2y = q[:, 1], q[:, 3], q[:, 5]
    a = p0y - 2 * p1y + p2y
    big = torch.maximum(torch.maximum(p0y.abs(), p1y.abs()), p2y.abs()).double()
    m = torch.clamp(torch.clamp(big, min=float(ymax)), min=1.0)
    den = a.double().abs() - 8.0 * m * U
    bound = torch.clamp(160.0 * m * m * U / den + 32.0 * m * U, min=1.0)
    bound = torch.where(den > 0, bound, torch.inf)
    return torch.where(a == 0, 1.0, bound)


def page_rows(q, top: int, rows: int, page_w: int):
    """The CUDA kernel's row cull: bool ``[S, rows]``, True for the
    (segment, row) pairs it solves: those the page solves
    (``solved_rows``) whose row's sample y lies within ``margin`` of the
    segment's control-hull y-range. The margin is exact, so the kernel
    places every crossing of the page."""
    cy = row_coords(top, rows, q.device).double()
    ymax = float(cy.abs().max()) if rows else 0.0
    ys = q[:, 1::2]
    m = margin(q, ymax)
    lo = ys.amin(dim=1).double() - m
    hi = ys.amax(dim=1).double() + m
    near = (cy[None, :] >= lo[:, None]) & (cy[None, :] <= hi[:, None])
    return near & solved_rows(q, top, rows, page_w)
