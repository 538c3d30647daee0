"""Page rendering: a text layout -> a whole pixel page.

The port of the direct and colour paths of
``fontrx/scene/page.py::PageRenderer``: ``render_direct`` (lines 418-517,
with ``_compact_instances``, lines 519-554), ``render_color`` (lines
579-623, with ``_tile_size``, lines 323-329) and ``to_rgba`` (lines
559-577).

The direct path renders in one kernel launch: every instance's live
em-space segments are concatenated once per layout, with an owning instance
per segment; a frame computes the instances' page-pixel offsets for its view
on the host and rasters the page from that stream with ``kernels.page`` (the
CUDA page kernels on a CUDA device, their plain versions on the CPU): the
fill, the debug gray, a band, or the 2 x 2 MSAA page.

The colour path (COLR v0 layers, ``fontrx_torch.engine.colorglyphs``)
rasters premultiplied RGBA tiles of the layout's glyphs once per zoom, one
coverage launch for all their layers, and composites them src-over at the
instances' pen positions.

Left out: the shape buckets of the reference's stream (2048 segments) and
offsets (256 instances), which only keep XLA's shapes stable (the one trace
their padding leaves on the page, the padding point in the hull of a last
chunk that is not full, is part of ``kernels.page_ref``'s function); and
composite mode (``render``, ``rasterize_glyphs``, ``GlyphTileCache``;
ROADMAP item 8).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from fontrx_torch.engine.colorglyphs import color_glyph_tiles, composite_color_page, ink_boxes
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import page
from fontrx_torch.scene.layout import TextLayout
from fontrx_torch.scene.transform import ViewTransform


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class PageRenderer:
    """Renders a ``TextLayout`` under a ``ViewTransform`` to a ``height x
    width`` page on ``device`` (``"cuda"``, ``"cuda:1"``, ``"cpu"`` or a
    ``torch.device``)."""

    font: Font
    layout: TextLayout
    width: int
    height: int
    device: torch.device | str
    _compact_cache: tuple | None = field(default=None, repr=False)
    # the colour tiles of the last zoom: ((px_per_unit, palette, tile),
    # tiles, grids, ink boxes)
    _color_cache: tuple | None = field(default=None, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)

    def page_inputs(self, view: ViewTransform):
        """What the page kernel takes for ``view``: ``(flat_segments
        float32 [S, 3, 2], seg_inst_idx int32 [S], inst_offsets float32
        [N, 2], s_px)``, the tensors on the renderer's device.

        ``s_px`` is ``float32(view.scale[0] * (width / 2))``; each offset is
        the instance's em origin in page pixels, y up (page row ``r``
        samples ``y = height - 1 - r``), computed in float64 and rounded
        once to float32."""
        flat_segments, seg_inst_idx, em = self._compact_instances()
        s_px = np.float32(view.scale[0] * (self.width / 2.0))
        ndc_x = em[:, 0] * view.scale[0] + view.offset[0]
        ndc_y = (em[:, 1] * view.scale[1] + view.offset[1]) * view.aspect_ratio
        xs = np.empty((len(em), 2), np.float32)
        xs[:, 0] = (ndc_x + 1.0) / 2.0 * self.width
        xs[:, 1] = (ndc_y + 1.0) / 2.0 * self.height
        return flat_segments, seg_inst_idx, torch.from_numpy(xs).to(self.device), s_px

    def render_direct(
        self, view: ViewTransform, msaa: bool = False, debug: bool = False,
        band: tuple[int, int] | None = None,
    ) -> torch.Tensor:
        """One frame: uint8 ``[height, width]`` on the renderer's device, the
        0/255 fill, with ``debug`` the winding gray ``clip(w * 20 + 100, 0,
        255)``, or with ``msaa`` (which wins over ``debug``) the 2 x 2 MSAA
        page (0, 63, 127, 191, 255). ``band=(y0, rows)`` renders page rows
        ``[y0, y0 + rows)`` of the fill only, equal to the same rows of the
        whole page at the first view. One launch of a page kernel on a CUDA
        device."""
        y0, rows = (0, self.height) if band is None else band
        if len(self.layout.instances) == 0:
            return torch.zeros((rows, self.width), dtype=torch.uint8, device=self.device)
        if band is not None and (msaa or debug):
            raise ValueError("band renders are fill-only")
        if msaa:
            return page.direct_page_msaa(*self.page_inputs(view), page_h=self.height,
                                         page_w=self.width)
        return page.direct_page(
            *self.page_inputs(view), y0, page_h=self.height, page_w=self.width,
            out_h=rows, mode="gray" if debug else "fill")

    def _tile_size(self, px_per_unit: float) -> int:
        """The colour tiles' side at ``px_per_unit``: the next power of two
        above the layout's largest glyph box span in pixels plus 2, within
        [128, 2048] (128 for an empty layout)."""
        boxes = np.asarray(self.layout.batch.boxes)
        if len(boxes) == 0:
            return 128
        spans = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
        max_px = float(spans.max()) * px_per_unit
        return min(max(_next_pow2(int(max_px) + 2), 128), 2048)

    def render_color(self, view: ViewTransform, palette: int = 0, samples: int = 2,
                     plain: bool = False) -> np.ndarray:
        """One COLR/CPAL colour frame: uint8 ``[height, width, 3]`` on the
        host, over white: ``color_tiles`` composited src-over at
        ``color_pen``'s positions. ``plain`` runs the plain versions of the
        coverage kernel and of the composite on the renderer's device."""
        tiles, grids, ink = self.color_tiles(view, palette, samples, plain)
        slots, pen = self.color_pen(view)
        return composite_color_page(tiles, grids, slots, pen, page_h=self.height,
                                    page_w=self.width, ink=ink, plain=plain)

    def color_tiles(self, view: ViewTransform, palette: int = 0, samples: int = 2,
                    plain: bool = False):
        """``(tiles, grids, ink boxes)`` of the layout's glyphs at ``view``'s
        zoom (``color_glyph_tiles``, ``ink_boxes``; glyphs without colour
        layers are one layer in black), on the renderer's device. They
        raster once per (zoom, palette, tile size) and are cached; with
        ``plain`` the coverage is the plain version's, and nothing is
        cached."""
        px_per_unit = view.scale[0] * (self.width / 2.0)
        if px_per_unit <= 0:
            raise ValueError("view scale must be positive")
        tile = self._tile_size(px_per_unit)
        key = (px_per_unit, palette, tile)
        if plain or self._color_cache is None or self._color_cache[0] != key:
            tiles, grids = color_glyph_tiles(
                self.font, [int(g) for g in self.layout.slot_gids],
                px_per_unit * self.font.info.units_per_em, RasterEngine(self.device),
                palette=palette, samples=samples, tile=tile, plain=plain)
            if plain:
                return tiles, grids, None
            self._color_cache = (key, tiles, grids, ink_boxes(tiles))
        return self._color_cache[1:]

    def color_pen(self, view: ViewTransform):
        """``(slots int32 [N], pen float64 [N, 2])``: each instance's glyph
        slot and pen position in page pixels (x right, y down) at
        ``view``."""
        slots, offsets = self.layout.instance_arrays()
        em = offsets.astype(np.float64)
        ndc_x = em[:, 0] * view.scale[0] + view.offset[0]
        ndc_y = (em[:, 1] * view.scale[1] + view.offset[1]) * view.aspect_ratio
        pen = np.empty((len(slots), 2), np.float64)
        pen[:, 0] = (ndc_x + 1.0) / 2.0 * self.width
        pen[:, 1] = (1.0 - ndc_y) / 2.0 * self.height
        return slots, pen

    @staticmethod
    def to_rgba(page_u8, transparent: bool = False) -> np.ndarray:
        """A page (a tensor or an array) as uint8 RGBA ``[H, W, 4]`` on the
        host. A colour page (uint8 ``[H, W, 3]``) keeps its colour and is
        opaque. A grayscale page (uint8 ``[H, W]``) has its gray in R, G and
        B, and alpha the coverage with ``transparent`` (the reference's
        transparent-framebuffer mode, Ctrl+T), else 255 (opaque over
        black)."""
        if torch.is_tensor(page_u8):
            page_u8 = page_u8.cpu().numpy()
        if page_u8.ndim == 3:
            rgba = np.empty(page_u8.shape[:2] + (4,), np.uint8)
            rgba[..., :3] = page_u8
            rgba[..., 3] = 255
            return rgba
        a = page_u8.astype(np.uint8)
        rgba = np.empty(a.shape + (4,), np.uint8)
        rgba[..., :3] = a[..., None]
        rgba[..., 3] = a if transparent else 255
        return rgba

    def _compact_instances(self):
        """Every instance's live segments concatenated, padding dropped,
        with the owning instance of each, and the instances' em-space pen
        offsets: ``(float32 [S, 3, 2], int32 [S])`` on the renderer's
        device and float64 ``[N, 2]`` on the host, built once per layout
        (the reference rebuilds the offsets every frame)."""
        if self._compact_cache is not None:
            return self._compact_cache
        slots, offsets_em = self.layout.instance_arrays()
        batch = self.layout.batch
        counts = np.asarray(batch.seg_counts)[slots]
        seg = np.concatenate(
            [batch.segments[slot, :n] for slot, n in zip(slots, counts)]
            + [np.zeros((0, 3, 2), np.float32)])
        idx = np.repeat(np.arange(len(slots), dtype=np.int32), counts)
        self._compact_cache = (torch.from_numpy(seg).to(self.device),
                               torch.from_numpy(idx).to(self.device),
                               offsets_em.astype(np.float64))
        return self._compact_cache
