"""COLR v0 colour glyphs: layered coverage tiles and their src-over page
composite.

The port of the COLR v0 part of ``fontrx/engine/colorglyphs.py``:

- ``color_glyph_tiles``: premultiplied RGBA tiles, float32 ``[N, tile,
  tile, 4]``, and each tile's ``RasterGrid``. Every (glyph, layer) row of
  the request is one row of a single ``RasterEngine.coverage_batch`` call at
  ``k = max(samples, 2)`` (the coverage kernel, ``csrc/coverage.cu``, on a
  CUDA device); the layers of a glyph share one grid, anchored at the union
  of their boxes, and fold bottom to top, src-over, ``acc = acc * (1 - a) +
  src`` on all four channels. A glyph without COLR layers is one layer of
  its own outline in the foreground colour;
- ``color_tiles``: the same tiles over an opaque background, uint8;
- ``composite_color_page``: the tiles placed src-over at the layout's pen
  positions on an opaque page, uint8 ``[H, W, 3]`` on the host.

The colour constants are built on the host as the original builds them, so
that the device rounds the same operations: ``av = cov * f32(a / 255)`` (the
double rounded once to float32) and ``rgb = f32(c) / f32(255)``. Each torch
operation rounds on its own (no FMA contraction; nothing here may be
compiled).

Src-over does not commute, so the page composite keeps each pixel's instance
order. The plain version (``serial_fold``) is the original's: a page padded
by one tile on every side, each instance's origin clamped into it, every
instance blended whole in order. The main path (``rank_fold``) gives the same
bits with one batched blend per cover rank: a tile pixel whose four channels
are 0 blends as the identity, and a clamped tile lies wholly outside the
page, so it blends only the inked rectangle of each tile (``ink_boxes``)
within the page, and its step ``r`` blends, at each page pixel, the ``r``-th
instance that inks it.

Every other paint raises ``NotImplementedError`` naming ROADMAP item 13b:
COLR v1 paint graphs (``fontrx_torch.font.colr``), OT-SVG documents
(``Font.color_paint_tree``), sbix and CBDT bitmaps, and tree nodes other
than solid glyph layers.
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch.convert import grid_anchors, to_device
from fontrx_torch.kernels import coverage_ref
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import pack_glyphs

NOT_PORTED = "(ROADMAP item 13b)"


def color_glyph_tiles(font, gids, size: float, engine, *, palette: int = 0, samples: int = 2,
                      foreground: tuple[int, int, int, int] = (0, 0, 0, 255),
                      tile: int | None = None, plain: bool = False):
    """Premultiplied RGBA colour tiles, float32 ``[len(gids), tile, tile,
    4]`` in [0, 1] on the engine's device, and the ``RasterGrid`` anchoring
    each.

    ``size`` is the em size in pixels (the page path's is fractional),
    ``tile`` the side of each tile (``round(size)`` by default). One
    coverage launch covers every (glyph, layer) row; with ``plain`` the
    coverage is the plain version's (``coverage_ref``) on the same device.
    """
    if tile is None:
        tile = max(int(round(size)), 1)
    upem = font.info.units_per_em
    glyphs = []
    cells = []
    row_grid: list[RasterGrid] = []
    cell_grids: list[RasterGrid] = []
    for gid in gids:
        tree = font.color_paint_tree(gid, palette, foreground)
        if tree is None:
            if b"sbix" in font.tables or b"CBDT" in font.tables:
                raise NotImplementedError(
                    f"bitmap colour glyphs (sbix, CBDT) are not ported {NOT_PORTED}")
            tree = ("layers", [("glyph", gid, ("solid", foreground), None)])
        loaded = []

        def collect(node):
            # each glyph leaf gets its row of the coverage batch
            if node[0] == "glyph":
                _, lg, paint, xf = node
                if paint[0] != "solid" or xf is not None:
                    raise NotImplementedError(
                        f"colour paint {paint[0]!r}{' with a transform' if xf else ''}: only "
                        f"solid COLR v0 layers are ported {NOT_PORTED}")
                g = font.load_glyph_safe(lg)
                row = len(glyphs)
                glyphs.append(g)
                loaded.append(g)
                return ("glyph", row, paint, xf)
            if node[0] == "layers":
                return ("layers", [collect(k) for k in node[1]])
            raise NotImplementedError(
                f"colour paint node {node[0]!r}: only COLR v0 layers are ported {NOT_PORTED}")

        n_before = len(glyphs)
        rowtree = collect(tree)
        clip = font.colr.clip_box(gid) if font.colr is not None else None
        boxes = [g.box for g in loaded]
        if clip is not None:
            union = clip
        elif boxes:
            union = (min(b.x_min for b in boxes), min(b.y_min for b in boxes),
                     max(b.x_max for b in boxes), max(b.y_max for b in boxes))
        else:
            union = (0, 0, 1, 1)
        grid = RasterGrid.fixed_tile(union, size, upem, tile)
        row_grid.extend([grid] * (len(glyphs) - n_before))
        cells.append(rowtree)
        cell_grids.append(grid)

    dev = torch.device(engine.device)
    if not cells:
        return torch.zeros((0, tile, tile, 4), dtype=torch.float32, device=dev), []
    args = (pack_glyphs(glyphs).segments, *grid_anchors(row_grid))
    kwargs = dict(height=tile, width=tile, samples=max(samples, 2))
    if plain:
        cov = coverage_ref.coverage_batch(*to_device(*args, dev), **kwargs)
    else:
        cov = engine.coverage_batch(*args, **kwargs)
    tiles = torch.empty((len(cells), tile, tile, 4), dtype=torch.float32, device=dev)
    for i, rowtree in enumerate(cells):
        tiles[i] = _eval_node(rowtree, cov, tile)
    return tiles, cell_grids


def _eval_node(node, cov: torch.Tensor, tile: int) -> torch.Tensor:
    """A row-annotated COLR v0 tree as a premultiplied RGBA tile, float32
    ``[tile, tile, 4]``."""
    dev = cov.device
    if node[0] == "glyph":
        _, row, (_, (r, g, b, a)), _ = node
        # the constants round on the host, as the original's do
        av = cov[row][..., None] * torch.tensor(np.float32(a / 255.0), device=dev)
        rgb = torch.from_numpy(np.asarray((r, g, b), np.float32) / np.float32(255.0)).to(dev)
        return torch.cat([rgb * av, av], dim=-1)
    acc = torch.zeros((tile, tile, 4), dtype=torch.float32, device=dev)
    for k in node[1]:
        src = _eval_node(k, cov, tile)
        acc = acc * (1.0 - src[..., 3:]) + src
    return acc


def _over_background(rgba: torch.Tensor, background) -> np.ndarray:
    """Premultiplied RGBA over an opaque background, as uint8 RGB on the
    host: ``bg * (1 - a) + rgb``, times 255, rounded half to even, clipped."""
    bg = torch.from_numpy(np.asarray(background, np.float32) / np.float32(255.0))
    rgb = bg.to(rgba.device) * (1.0 - rgba[..., 3:]) + rgba[..., :3]
    return torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8).cpu().numpy()


def color_tiles(font, gids, size: int, engine, *, palette: int = 0, samples: int = 2,
                foreground: tuple[int, int, int, int] = (0, 0, 0, 255),
                background: tuple[int, int, int] = (255, 255, 255)) -> np.ndarray:
    """``size x size`` RGB tiles over an opaque background: uint8
    ``[len(gids), size, size, 3]`` on the host."""
    rgba, _ = color_glyph_tiles(font, gids, size, engine, palette=palette, samples=samples,
                                foreground=foreground)
    return _over_background(rgba, background)


def ink_boxes(tiles: torch.Tensor) -> np.ndarray:
    """Per tile, the rows and columns ``(r0, r1, c0, c1)`` that hold every
    pixel whose four channels are not all 0; ``(0, 0, 0, 0)`` for a tile
    with none. int64 ``[N, 4]`` on the host."""
    n, t = tiles.shape[:2]
    inked = (tiles != 0).any(dim=3)
    rows = inked.any(dim=2).cpu().numpy()
    cols = inked.any(dim=1).cpu().numpy()
    out = np.zeros((n, 4), np.int64)
    some = rows.any(axis=1)
    out[some, 0] = rows[some].argmax(axis=1)
    out[some, 1] = t - rows[some, ::-1].argmax(axis=1)
    out[some, 2] = cols[some].argmax(axis=1)
    out[some, 3] = t - cols[some, ::-1].argmax(axis=1)
    return out


def tile_origins(grids, slots, pen_px, tile: int, page_h: int, page_w: int):
    """Each instance's tile origin ``(x0, y0)`` in the page padded by one
    tile on every side, as the original places it: ``round(pen) +
    (grid.min_x, -grid.max_y)`` as int32, plus ``tile``, clamped to ``[0,
    page + tile]``. int64 ``[N]`` each."""
    g_minx = np.array([g.min_x for g in grids], np.int64)[slots]
    g_maxy = np.array([g.max_y for g in grids], np.int64)[slots]
    xs = (np.round(pen_px[:, 0]).astype(np.int64) + g_minx).astype(np.int32)
    ys = (np.round(pen_px[:, 1]).astype(np.int64) - g_maxy).astype(np.int32)
    x0 = np.clip(xs.astype(np.int64) + tile, 0, page_w + tile)
    y0 = np.clip(ys.astype(np.int64) + tile, 0, page_h + tile)
    return x0, y0


def serial_fold(tiles: torch.Tensor, slots, x0, y0, page_h: int, page_w: int) -> torch.Tensor:
    """The plain composite: every instance's whole tile blended src-over, in
    order, into a zero page padded by one tile on every side (origins from
    ``tile_origins``), cropped: float32 ``[page_h, page_w, 4]``."""
    t = tiles.shape[1]
    page = torch.zeros((page_h + 2 * t, page_w + 2 * t, 4), dtype=torch.float32,
                       device=tiles.device)
    for s, x, y in zip(np.asarray(slots).tolist(), x0.tolist(), y0.tolist()):
        src = tiles[s]
        cur = page[y:y + t, x:x + t]
        page[y:y + t, x:x + t] = cur * (1.0 - src[..., 3:]) + src
    return page[t:t + page_h, t:t + page_w]


def _covers(t: int, slots, left, top, page_h: int, page_w: int, ink, dev):
    """The flat page pixel and tile texel of every (instance, pixel) cover:
    the pixels of each instance's inked rectangle (``ink[slot]``, placed at
    the tile's page origin ``(left, top)``) that lie on the page, instance
    after instance. int64 ``[P]`` each on ``dev``."""
    box = ink[slots]
    r0 = np.maximum(top + box[:, 0], 0)
    r1 = np.minimum(top + box[:, 1], page_h)
    c0 = np.maximum(left + box[:, 2], 0)
    c1 = np.minimum(left + box[:, 3], page_w)
    keep = (r1 > r0) & (c1 > c0)
    w = (c1 - c0)[keep]
    n = (r1 - r0)[keep] * w
    total = int(n.sum())
    w, n, first, r0, c0, top, left, slot = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (w, n, np.cumsum(n) - n, r0[keep], c0[keep], top[keep], left[keep],
                  slots[keep]))
    inst = torch.repeat_interleave(torch.arange(len(n), device=dev), n, output_size=total)
    local = torch.arange(total, device=dev) - first[inst]
    row = r0[inst] + torch.div(local, w[inst], rounding_mode="floor")
    col = c0[inst] + torch.remainder(local, w[inst])
    return row * page_w + col, (slot[inst] * t + row - top[inst]) * t + col - left[inst]


def rank_fold(tiles: torch.Tensor, slots, x0, y0, page_h: int, page_w: int,
              ink: np.ndarray) -> torch.Tensor:
    """``serial_fold``'s page, bit for bit, in one batched blend per cover
    rank: each instance covers the pixels of its tile's inked rectangle
    (``ink``, from ``ink_boxes``) that lie on the page; step ``r`` blends, at
    every page pixel, the ``r``-th instance in order that covers it."""
    t = tiles.shape[1]
    dev = tiles.device
    page = torch.zeros((page_h * page_w, 4), dtype=torch.float32, device=dev)
    pix, texel = _covers(t, np.asarray(slots, np.int64), x0 - t, y0 - t, page_h, page_w, ink,
                         dev)
    if len(pix):
        # each cover's rank among the covers of its pixel, in instance
        # order: its place in the stable sort by pixel less its pixel's first
        sorted_pix, order = torch.sort(pix, stable=True)
        rank = (torch.arange(len(pix), device=dev)
                - torch.searchsorted(sorted_pix, sorted_pix, right=False))
        sizes = torch.bincount(rank).tolist()
        if len(sizes) > 1:  # some pixel has two covers: blend rank by rank
            by_rank = order[torch.argsort(rank, stable=True)]
            pix, texel = pix[by_rank], texel[by_rank]
        flat = tiles.reshape(-1, 4)
        for p, tx in zip(torch.split(pix, sizes), torch.split(texel, sizes)):
            src = flat[tx]
            page[p] = page[p] * (1.0 - src[:, 3:]) + src
    return page.reshape(page_h, page_w, 4)


def composite_color_page(tiles_rgba: torch.Tensor, grids, slots, pen_px, *, page_h: int,
                         page_w: int, background: tuple[int, int, int] = (255, 255, 255),
                         ink: np.ndarray | None = None, plain: bool = False) -> np.ndarray:
    """Src-over placement of premultiplied RGBA tiles on an opaque page:
    uint8 ``[page_h, page_w, 3]`` on the host.

    ``slots``: int ``[N]``, the tile of each instance; ``pen_px``: float
    ``[N, 2]``, page-pixel pen positions (x right, y down). An instance's
    tile origin is ``round(pen) + (grid.min_x, -grid.max_y)``, clamped as
    the original clamps it (``tile_origins``). ``ink``: the tiles'
    ``ink_boxes``, computed when not given. ``plain`` runs the plain version,
    ``serial_fold``; the main path is ``rank_fold``.
    """
    if len(slots) == 0:
        out = np.zeros((page_h, page_w, 3), np.uint8)
        out[:] = background
        return out
    tile = int(tiles_rgba.shape[1])
    x0, y0 = tile_origins(grids, slots, pen_px, tile, page_h, page_w)
    if plain:
        rgba = serial_fold(tiles_rgba, slots, x0, y0, page_h, page_w)
    else:
        if ink is None:
            ink = ink_boxes(tiles_rgba)
        rgba = rank_fold(tiles_rgba, slots, x0, y0, page_h, page_w, ink)
    return _over_background(rgba, background)
