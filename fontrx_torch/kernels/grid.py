"""Raster-grid geometry: the exact pixel -> em-space mapping.

A copy of ``fontrx/kernels/grid.py``, the one source of the coordinate
conventions:

- ``scale = font_size / units_per_em``            (float32)
- the pixel grid covers the glyph bbox scaled by ``scale``, floor/ceil
  expanded, **plus one pixel** on each axis,
- pixel ``(x, y)`` samples the em-space point
  ``((min_x + x) / scale, (max_y - y) / scale)``; y runs top-down.

All arithmetic is float32 in one operation order, so that the oracle, the
plain versions and the kernels land on the same sample coordinates.
``tests/test_torch_frontend.py`` holds it equal to the original.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True, slots=True)
class RasterGrid:
    """A pixel grid over em space.

    ``min_x``/``max_y`` are integer pixel-space corners; sample ``(x, y)``
    maps to em-space ``((min_x + x)/scale, (max_y - y)/scale)``.
    """

    width: int
    height: int
    min_x: int
    max_y: int
    scale: float  # pixels per font unit (float32-rounded)

    @classmethod
    def for_glyph_box(
        cls,
        box: tuple[int, int, int, int],
        font_size: int,
        units_per_em: int,
    ) -> "RasterGrid":
        """The grid over a glyph's scaled bbox, floor/ceil expanded."""
        scale = np.float32(font_size) / np.float32(units_per_em)
        x_min, y_min, x_max, y_max = box
        bx0 = np.float32(x_min) * scale
        by0 = np.float32(y_min) * scale
        bx1 = np.float32(x_max) * scale
        by1 = np.float32(y_max) * scale
        min_x = int(math.floor(bx0))
        min_y = int(math.floor(by0))
        max_x = int(math.ceil(bx1))
        max_y = int(math.ceil(by1))
        return cls(
            width=max_x - min_x + 1,
            height=max_y - min_y + 1,
            min_x=min_x,
            max_y=max_y,
            scale=float(scale),
        )

    @classmethod
    def fixed_tile(
        cls,
        box: tuple[int, int, int, int],
        font_size: int,
        units_per_em: int,
        tile: int,
    ) -> "RasterGrid":
        """A fixed ``tile x tile`` grid anchored at the glyph bbox corner,
        for batched atlases (every glyph of a batch shares (H, W))."""
        g = cls.for_glyph_box(box, font_size, units_per_em)
        return cls(width=tile, height=tile, min_x=g.min_x, max_y=g.max_y, scale=g.scale)

    def padded(self, multiple_h: int, multiple_w: int) -> "RasterGrid":
        """Round H/W up to tile multiples (extra pixels sample past the
        glyph box and read winding 0; crop afterwards)."""

        def up(n: int, m: int) -> int:
            return ((n + m - 1) // m) * m

        return RasterGrid(
            width=up(self.width, multiple_w),
            height=up(self.height, multiple_h),
            min_x=self.min_x,
            max_y=self.max_y,
            scale=self.scale,
        )

    def sample_coords(self) -> tuple[np.ndarray, np.ndarray]:
        """Em-space sample coordinates ``(cx[W], cy[H])`` float32: the
        integer add first, then one float32 divide."""
        scale = np.float32(self.scale)
        xs = (self.min_x + np.arange(self.width)).astype(np.float32) / scale
        ys = (self.max_y - np.arange(self.height)).astype(np.float32) / scale
        return xs, ys
