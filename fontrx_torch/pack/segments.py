"""Packing normalized glyph outlines into padded segment arrays.

A copy of the single-batch packers of ``fontrx/pack/segments.py``; the
split, bucketed and hybrid packers stay out (``RasterEngine.winding_split``
and ``winding_hybrid`` take any object with their fields). Segments are
zero-padded, and zero segments add no winding. The segment capacity is
rounded up to a multiple of ``SEG_ALIGN``. ``tests/test_torch_frontend.py``
holds it equal to the original.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence
from dataclasses import dataclass

import numpy as np

from fontrx_torch.font.glyph import Glyph

SEG_ALIGN = 64  # segment-count granularity


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True, slots=True)
class PackedGlyph:
    """One glyph as a padded segment array.

    ``segments``: float32 ``[S, 3, 2]`` — (p0, p1, p2) per quadratic, in
    font units. ``box``: int ``(x_min, y_min, x_max, y_max)``.
    """

    segments: np.ndarray
    seg_count: int
    box: tuple[int, int, int, int]
    advance_width: int = 0

    @property
    def capacity(self) -> int:
        return self.segments.shape[0]


def ysort_segments(seg: np.ndarray) -> np.ndarray:
    """Reorder a ``[n, 3, 2]`` segment array by y-span midpoint (ascending,
    stable). Winding is an order-independent integer sum, so rasters are
    the same under any order."""
    if len(seg) < 2:
        return seg
    ymid = seg[:, :, 1].min(axis=1) + seg[:, :, 1].max(axis=1)
    order = np.argsort(ymid, kind="stable")
    return seg[order]


def xsort_segments(seg: np.ndarray) -> np.ndarray:
    """Reorder a ``[n, 3, 2]`` segment array by x-span midpoint (ascending,
    stable)."""
    if len(seg) < 2:
        return seg
    xmid = seg[:, :, 0].min(axis=1) + seg[:, :, 0].max(axis=1)
    order = np.argsort(xmid, kind="stable")
    return seg[order]


def glyph_segments(glyph: Glyph) -> np.ndarray:
    """A glyph's contours as an unpadded float32 ``[n, 3, 2]`` segment
    array, in contour order: points ``p[0..2k]`` give segments
    ``(p[2i], p[2i+1], p[2i+2])``."""
    chunks = []
    for contour in glyph.contours:
        pts = contour.points
        k = len(pts) // 2
        if k == 0:
            continue
        seg = np.stack([pts[0 : 2 * k : 2], pts[1 : 2 * k : 2], pts[2 : 2 * k + 1 : 2]], axis=1)
        chunks.append(seg)
    if not chunks:
        return np.empty((0, 3, 2), dtype=np.float32)
    return np.concatenate(chunks, axis=0).astype(np.float32)


def pack_glyph(
    glyph: Glyph, capacity: int | None = None, advance_width: int = 0
) -> PackedGlyph:
    """Pack one glyph, zero-padding to ``capacity`` (default: segment
    count rounded up to ``SEG_ALIGN``)."""
    seg = ysort_segments(glyph_segments(glyph))
    n = len(seg)
    if capacity is None:
        capacity = max(_round_up(n, SEG_ALIGN), SEG_ALIGN)
    if n > capacity:
        raise ValueError(f"glyph has {n} segments > capacity {capacity}")
    padded = np.zeros((capacity, 3, 2), dtype=np.float32)
    padded[:n] = seg
    box = (glyph.box.x_min, glyph.box.y_min, glyph.box.x_max, glyph.box.y_max)
    return PackedGlyph(padded, n, box, advance_width)


@dataclass(frozen=True, slots=True)
class PackedBatch:
    """A batch of glyphs padded to a common segment capacity.

    - ``segments``: float32 ``[B, S, 3, 2]``
    - ``seg_counts``: int32 ``[B]``
    - ``boxes``: int32 ``[B, 4]`` (x_min, y_min, x_max, y_max)
    - ``advance_widths``: int32 ``[B]``
    """

    segments: np.ndarray
    seg_counts: np.ndarray
    boxes: np.ndarray
    advance_widths: np.ndarray

    def __len__(self) -> int:
        return self.segments.shape[0]

    @property
    def capacity(self) -> int:
        return self.segments.shape[1]


def pack_glyphs(
    glyphs: Sequence[Glyph],
    advance_widths: Iterable[int] | None = None,
    capacity: int | None = None,
    pad_batch_to: int | None = None,
    sort: str = "y",
) -> PackedBatch:
    """Pack many glyphs into one batch. ``pad_batch_to`` pads the batch
    with empty glyphs; ``sort`` orders each glyph's segments by ``"y"``
    (default) or ``"x"`` midpoint, with the same rasters either way."""
    sorter = xsort_segments if sort == "x" else ysort_segments
    seg_arrays = [sorter(glyph_segments(g)) for g in glyphs]
    counts = [len(s) for s in seg_arrays]
    if capacity is None:
        capacity = max(_round_up(max(counts, default=0), SEG_ALIGN), SEG_ALIGN)
    b = len(glyphs)
    if pad_batch_to is not None:
        b = max(b, pad_batch_to)
    segments = np.zeros((b, capacity, 3, 2), dtype=np.float32)
    seg_counts = np.zeros(b, dtype=np.int32)
    boxes = np.zeros((b, 4), dtype=np.int32)
    for i, (g, seg, n) in enumerate(zip(glyphs, seg_arrays, counts)):
        if n > capacity:
            raise ValueError(f"glyph {i} has {n} segments > capacity {capacity}")
        segments[i, :n] = seg
        seg_counts[i] = n
        boxes[i] = (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max)
    aw = np.zeros(b, dtype=np.int32)
    if advance_widths is not None:
        for i, w in enumerate(advance_widths):
            aw[i] = w
    return PackedBatch(segments, seg_counts, boxes, aw)
