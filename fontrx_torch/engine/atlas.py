"""Atlas batching: rasterize a whole glyph set in one kernel launch.

The port of ``fontrx.engine.atlas``. ``pack_charset`` is the reference's
Python packing path; the reference's native C++ packer is not ported, and
the reference holds its two paths array-equal (``tests/test_torch_engine.py``
holds the port to both).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.font.font import Font
from fontrx_torch.pack.segments import PackedBatch, pack_glyphs


@dataclass(frozen=True, slots=True)
class AtlasLayout:
    """Glyph-tile placement in an atlas sheet: ``cols x rows`` tiles of
    ``tile x tile`` pixels, row-major by glyph order."""

    tile: int
    cols: int
    rows: int
    chars: tuple[int, ...]

    @property
    def width(self) -> int:
        return self.cols * self.tile

    @property
    def height(self) -> int:
        return self.rows * self.tile

    def tile_origin(self, i: int) -> tuple[int, int]:
        return (i % self.cols) * self.tile, (i // self.cols) * self.tile


def pack_charset(
    font: Font,
    chars: str | list[int],
    pad_batch_to: int | None = None,
) -> PackedBatch:
    """Load and pack a character set from a font: code points resolve to
    glyph indices in one vectorized lookup, then every glyph is loaded
    (one that fails to load packs as empty) and packed."""
    codes = [ord(c) for c in chars] if isinstance(chars, str) else list(chars)
    idx = font.charmap.glyph_indices(np.array(codes, np.int64))
    widths = np.asarray(font.advance_widths)[idx].astype(np.int32)
    glyphs = [font.load_glyph_safe(int(i)) for i in idx]
    return pack_glyphs(glyphs, widths.tolist(), pad_batch_to=pad_batch_to)


def render_atlas(
    font: Font,
    chars: str | list[int],
    font_size: int,
    tile: int,
    engine: RasterEngine,
) -> tuple[np.ndarray, AtlasLayout]:
    """Rasterize a character set into one atlas sheet on the engine's
    device. Returns ``(uint8 [H, W] fill atlas, layout)``."""
    codes = [ord(c) for c in chars] if isinstance(chars, str) else list(chars)
    batch = pack_charset(font, codes)
    winding_map, _grids = engine.winding_packed(
        batch, font_size, font.info.units_per_em, tile
    )
    fills = engine.fill(winding_map).cpu().numpy()  # [B, T, T]

    b = len(fills)
    cols = int(np.ceil(np.sqrt(b)))
    rows = (b + cols - 1) // cols
    sheet = np.zeros((rows * tile, cols * tile), np.uint8)
    for i in range(b):
        x0 = (i % cols) * tile
        y0 = (i // cols) * tile
        sheet[y0 : y0 + tile, x0 : x0 + tile] = fills[i]
    layout = AtlasLayout(tile, cols, rows, tuple(codes))
    return sheet, layout
