"""Plain PyTorch direct page render: the reference for the CUDA page kernel.

The port of ``fontrx/scene/page.py::_direct_page_step`` (lines 153-253):
every instance's live em-space segments go to page pixels (y up) with
one rounding, ``fma(flat_segments, s_px, offset)``, and the page is the
winding of that one stream as the reference's two TPU kernels compute it:
K7 (``winding_page.py:53-264``) for padded widths of 1024 px and more, the
v2 carry sweep (``winding_pallas_v2.py:131-520``) below that. At the sample
offset ``(ox, oy)`` row ``r`` samples ``y = f32(top - r) + oy``, ``top =
page_h - 1 - band_y0``, and column ``c`` samples ``x = f32(c) + ox``: the
TPU kernels' ``fdiv((max_y - row).astype(f32) + oy, scale)`` at scale 1.
Each (segment, row) pair gets the float program of ``phase_a_roots``
(``crossings``), exactly as ``winding_ref.winding_batch`` at batch 1 with
anchors ``(0, top)``, scale 1 and that sample offset.

Both TPU kernels cull by chunks of consecutive segments, and that cull is
part of the function. A quadratic that is nearly a line (an em-space line
after a rounded zoom) gets a tiny ``a``, its discriminant cancels, and the
float program gives it roots on rows far from its hull. Such a stray
crossing counts only where the kernels solve the pair, so the page is:

- per 128-row strip of the band and chunk of ``C`` segments (16 on the v2
  route, 32 on K7's), every pair is solved when the chunk's control hull,
  widened by 1 px, meets the strip's sample rows, and none otherwise;
- a crossing at ``xx`` in column tile ``t`` (``tw`` columns: 128, or 256 on
  K7's route when the padded width allows) adds its sign to every column of
  the tiles left of ``t``, and to the columns with ``x <= xx`` of tile ``t``
  only when the chunk's widened hull meets the row's 16-row window; one at or
  right of the padded width's edge ``f32(pw) + ox`` adds to every column;
- on K7's route a chunk whose widened x-hull ends left of the first
  column's ``x`` is skipped, a crossing counts only in the tiles within 2 px
  of that x-hull (``winding_page.py:222-238``), and one right of the padded
  width only when the x-hull reaches that edge;
- the reference pads the stream to a multiple of 2048 with segments at the
  point ``(-1e7, -1e7)``, so a last chunk that is not full has that point
  in its hull.

On a page without strays (the first view, whose transform is exact) this
equals the winding of every pair, as ``csrc/winding.cu`` computes it.

The 2 x 2 MSAA page (``direct_page_msaa``, the reference's
``render_direct(msaa=True)``, ``page.py:465-506``) takes the four offsets
of ``coverage_ref.sample_offsets(2)``, sums their 0/255 fills as integers
and divides by 4, rounding down: 0, 63, 127, 191 or 255. Below a padded
width of 1024 it is four single-sample pages. From 1024 the reference runs
K8 (``winding_page.py:329-534``) once per ``oy``: the pair function
(``windings`` with two x offsets). Its plane ``s`` is the single-sample
page at ``(ox_s, oy)`` but for two rules: a chunk is solved on a strip when
its widened x-hull reaches the smaller first-column ``x`` of the two
samples (``:385-409``), and a crossing of either sample counts in the
**union** of both samples' tile windows (``:480-505``). The right-edge
carry stays per sample (``:417-426``), and the 16-row windows are shared,
since both samples have the same rows. So a plane can differ from the
single pass only on stray roots, at tiles inside one sample's window and
outside the other's (or on a chunk that ends between the two first
columns): a crossing lies in its segment's x-hull up to rounding, and the
windows reach 2 px past that hull.

Nothing here runs on the card's path; the tests and ``chip_smoke.py``
compare the kernel with it.
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch.kernels import coverage_ref, winding_ref

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


def tile_range(hull, tile_w: int, oxs=(0.0,)):
    """K7's column tiles of a chunk (``winding_page.py:225-236``), and K8's
    union of them over the x offsets ``oxs`` (``:480-505``): float32
    ``(t_lo, t_hi)`` from its x-hull widened by 1 px, moved to pixels by
    ``- ox``, then widened by 2 px."""
    g_lo, g_hi = hull[..., 2] - 1.0, hull[..., 3] + 1.0
    lo = torch.stack([g_lo - _f32(ox) for ox in oxs]).amin(0)
    hi = torch.stack([g_hi - _f32(ox) for ox in oxs]).amax(0)
    return torch.floor((lo - 2.0) / tile_w), torch.floor((hi + 2.0) / tile_w)


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float: a scalar that float32
    tensor ops take exactly."""
    return float(np.float32(v))


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


def row_y(top: int, rows, oy=0.0):
    """Sample y of band rows ``rows`` (int64) below a row 0 at ``top``:
    float32 ``f32(top - r) + f32(oy)``, as the TPU kernels' ``cy`` at scale
    1."""
    return (top - rows).to(torch.float32) + _f32(oy)


def row_coords(top: int, rows: int, device=None, oy=0.0):
    """Sample y of rows ``0 .. rows-1`` below a row 0 at ``top``: float32
    ``f32(top - r) + f32(oy)``, as ``winding_ref.sample_coords`` at scale
    1."""
    return row_y(top, torch.arange(rows, device=device), oy)


def strip_chunks(hulls, top: int, strip: int, x_cull: bool, oy=0.0, oxs=(0.0,)):
    """Bool ``[n]``: the chunks the TPU kernels solve on strip ``strip`` of a
    band whose row 0 samples ``y = f32(top) + oy``, at the x offsets
    ``oxs``: with the x cull, those whose widened x-hull reaches the
    smallest first-column ``x``."""
    r0 = strip * STRIP_ROWS
    ok = meets(hulls, _f32(np.float32(top - r0) + np.float32(oy)),
               _f32(np.float32(top - r0 - (STRIP_ROWS - 1)) + np.float32(oy)))
    if x_cull:
        ok &= hulls[:, 3] + 1.0 >= min(_f32(ox) for ox in oxs)
    return ok


def deposits(q, hulls, seg_chunk, top: int, rows, *, page_w: int, oy=0.0, oxs=(0.0,)):
    """Where each crossing of segments ``q`` (float32 ``[S, 6]``, chunk
    index ``seg_chunk`` int64 ``[S]``) on band rows ``rows`` (int64
    ``[R]``, row 0 at ``y = f32(top) + oy``) lands for each x offset of
    ``oxs``: ``(k, sign)``, int64 ``[len(oxs), 2, S, R]`` and int32 ``[2,
    S, R]``, the crossing adding ``sign`` to columns ``[0, k)`` of its row
    in that sample's plane. With the x cull, its tile counts when it lies
    in the union of the samples' tile windows."""
    chunk, tile_w, x_cull = route(page_w)
    pw = padded_width(page_w)
    dev = q.device
    xx, sign, _ = crossings(q, row_y(top, rows, oy))
    h = hulls[seg_chunk][:, None, :]  # [S, 1, 4]
    w_top = rows - rows % WINDOW_ROWS  # each row's 16-row window
    window = meets(h, row_y(top, w_top, oy)[None, :],
                   row_y(top, w_top + (WINDOW_ROWS - 1), oy)[None, :])
    t_lo, t_hi = tile_range(h, tile_w, oxs)
    ks = []
    for ox in oxs:
        cx = torch.arange(pw, device=dev).to(torch.float32) + _f32(ox)
        cx_end = _f32(np.float32(pw) + np.float32(ox))
        k = torch.searchsorted(cx, xx.reshape(-1), right=True).reshape(xx.shape)
        tile = torch.div(k - 1, tile_w, rounding_mode="floor")
        k = torch.where(window[None], k, tile * tile_w)
        right = xx >= cx_end
        if x_cull:
            visited = (tile >= t_lo[None]) & (tile <= t_hi[None])
            k = torch.where(visited, k, 0)
            k = torch.where(right, torch.where(h[None, ..., 3] + 1.0 >= cx_end, pw, 0), k)
        else:
            k = torch.where(right, pw, k)
        ks.append(torch.clamp(k, 0, page_w))
    return torch.stack(ks), sign


def windings(q, top: int, out_h: int, page_w: int, oy=0.0, oxs=(0.0,)):
    """The winding of page-space segments ``q`` (float32 ``[S, 6]``) on
    ``out_h`` rows whose row 0 samples ``y = f32(top) + oy``, for each x
    offset of ``oxs``: int32 ``[len(oxs), out_h, page_w]``. One solve per
    (segment, row) pair serves every x offset. With one offset it is the
    single-sample page; with two on K7's route, K8's pair function."""
    dev = q.device
    chunk, _, x_cull = route(page_w)
    bucket = torch.zeros((len(oxs), out_h, page_w + 1), dtype=torch.int32, device=dev)
    if len(q):
        hulls = chunk_hulls(q, chunk)
        seg_chunk = torch.arange(len(q), device=dev) // chunk
        for strip in range(-(-out_h // STRIP_ROWS)):
            live = strip_chunks(hulls, top, strip, x_cull, oy, oxs)[seg_chunk]
            if not bool(live.any()):
                continue
            r0, r1 = strip * STRIP_ROWS, min(out_h, (strip + 1) * STRIP_ROWS)
            rows = torch.arange(r0, r1, device=dev)
            live_segs = torch.nonzero(live)[:, 0]
            for s0 in range(0, len(live_segs), _SEGMENTS_PER_STEP):
                segs = live_segs[s0 : s0 + _SEGMENTS_PER_STEP]
                k, sign = deposits(q[segs], hulls, seg_chunk[segs], top, rows, page_w=page_w,
                                   oy=oy, oxs=oxs)
                row = (rows[None, None, :].expand_as(sign) - r0).reshape(-1)
                for plane, kp in zip(bucket, k):
                    plane[r0:r1].index_put_((row, kp.reshape(-1)), sign.reshape(-1),
                                            accumulate=True)
    return bucket[..., 1:].flip(-1).cumsum(-1, dtype=torch.int32).flip(-1)


def direct_page(flat_segments, seg_inst_idx, inst_offsets, s_px, band_y0=0, *, page_h, page_w,
                out_h=None, mode="fill", sample_offset=(0.0, 0.0)):
    """Rows ``[band_y0, band_y0 + out_h)`` of the page (all of it by
    default) at the sample offset ``(ox, oy)``: ``[out_h, page_w]``, int32
    for ``mode="winding"``, else uint8.

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
    ox, oy = sample_offset
    q = transform_segments(flat_segments, seg_inst_idx, inst_offsets, s_px).reshape(-1, 6)
    return finish(windings(q, page_h - 1 - band_y0, oh, page_w, oy, (ox,))[0], mode)


def msaa_lattice():
    """The 2 x 2 MSAA page's samples as the reference groups them
    (``page.py:470-476``): ``[(oy, (ox0, ox1)), ...]``, both sorted, from
    ``coverage_ref.sample_offsets(2)``."""
    offsets = coverage_ref.sample_offsets(2)
    return [(oy, tuple(sorted(float(ox) for ox, y in offsets if float(y) == oy)))
            for oy in sorted({float(y) for y in offsets[:, 1]})]


def direct_page_msaa(flat_segments, seg_inst_idx, inst_offsets, s_px, *, page_h, page_w):
    """The 2 x 2 MSAA page, uint8 ``[page_h, page_w]``: the 0/255 fills of
    the four samples of ``msaa_lattice`` summed as integers and divided by
    4, rounding down (0, 63, 127, 191, 255). Per ``oy``, ``windings`` with
    both x offsets: four single-sample passes below a padded width of 1024,
    K8's pair function from it. Arguments as ``direct_page``'s."""
    q = transform_segments(flat_segments, seg_inst_idx, inst_offsets, s_px).reshape(-1, 6)
    count = torch.zeros((page_h, page_w), dtype=torch.int32, device=q.device)
    for oy, oxs in msaa_lattice():
        count += (windings(q, page_h - 1, page_h, page_w, oy, oxs) != 0).sum(0, dtype=torch.int32)
    return (count * 255 // 4).to(torch.uint8)


def row_roots(q, cy):
    """Crossings per (segment, row), int32 ``[S, R]``, and where a
    quadratic's discriminant is >= 0, bool ``[S, R]``."""
    _, sign, live = crossings(q, cy)
    return (sign != 0).sum(0, dtype=torch.int32), live


def strip_table(q, top: int, rows: int, page_w: int, oy=0.0, oxs=(0.0,)):
    """Bool ``[S, strips]``: the 128-row strips of a band of ``rows`` rows
    (row 0 at ``y = f32(top) + oy``) on which the page at the x offsets
    ``oxs`` solves each segment, those its chunk meets."""
    chunk, _, x_cull = route(page_w)
    n = -(-rows // STRIP_ROWS)
    if not len(q):
        return torch.zeros((0, n), dtype=torch.bool, device=q.device)
    hulls = chunk_hulls(q, chunk)
    seg_chunk = torch.arange(len(q), device=q.device) // chunk
    return torch.stack([strip_chunks(hulls, top, i, x_cull, oy, oxs)[seg_chunk]
                        for i in range(n)], 1)


def solved_rows(q, top: int, rows: int, page_w: int, oy=0.0, oxs=(0.0,)):
    """Bool ``[S, rows]``: the (segment, row) pairs the page solves."""
    row_strip = torch.arange(rows, device=q.device) // STRIP_ROWS
    return strip_table(q, top, rows, page_w, oy, oxs)[:, row_strip]


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


def page_rows(q, top: int, rows: int, page_w: int, oy=0.0, oxs=(0.0,)):
    """The CUDA kernel's row cull: bool ``[S, rows]``, True for the
    (segment, row) pairs it solves: those the page solves
    (``solved_rows``) whose row's sample y lies within ``margin`` of the
    segment's control-hull y-range, the margin taken over the ``|y|`` of
    these sample rows. The margin is exact, so the kernel places every
    crossing of the page."""
    cy = row_coords(top, rows, q.device, oy).double()
    ymax = float(cy.abs().max()) if rows else 0.0
    ys = q[:, 1::2]
    m = margin(q, ymax)
    lo = ys.amin(dim=1).double() - m
    hi = ys.amax(dim=1).double() + m
    near = (cy[None, :] >= lo[:, None]) & (cy[None, :] <= hi[:, None])
    return near & solved_rows(q, top, rows, page_w, oy, oxs)
