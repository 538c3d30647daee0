"""Normalized glyph outlines.

A copy of ``fontrx/font/glyph.py`` without the affine and shear helpers.
Every contour is a sequence of quadratic segments with the invariant:
even-index points are on-curve, odd-index points are off-curve controls,
and the last point equals the first. An on-curve midpoint, truncated to
integers toward zero, is inserted between two consecutive TrueType points
of the same kind. ``tests/test_torch_frontend.py`` holds it equal to the
original.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from fontrx_torch.font import ttf

log = logging.getLogger(__name__)


@dataclass(frozen=True, slots=True)
class Box:
    x_min: int
    y_min: int
    x_max: int
    y_max: int


@dataclass(frozen=True, slots=True)
class Contour:
    """One closed contour. ``points`` is ``int32 [2k+1, 2]`` satisfying
    the even-on-curve / odd-off-curve / closed invariant, so it encodes
    exactly ``k`` quadratic segments ``(p[2i], p[2i+1], p[2i+2])``."""

    points: np.ndarray

    @property
    def num_segments(self) -> int:
        return len(self.points) // 2


@dataclass(frozen=True, slots=True)
class Glyph:
    box: Box
    contours: tuple[Contour, ...]

    @property
    def num_segments(self) -> int:
        return sum(c.num_segments for c in self.contours)

    @classmethod
    def empty(cls) -> "Glyph":
        """An empty glyph (a space, or one that failed to load)."""
        return cls(Box(0, 0, 0, 0), ())


def _trunc_midpoint(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Integer midpoint truncated toward zero."""
    s = a.astype(np.int64) + b.astype(np.int64)
    return (np.sign(s) * (np.abs(s) // 2)).astype(np.int32)


def _normalize_contour(points: np.ndarray, on_curve: np.ndarray) -> np.ndarray:
    """Normalize one TTF contour to the even/odd invariant: walk the
    points with the previous point starting at the contour's last one,
    insert a truncated midpoint wherever previous and current share their
    on-curve state, then close the loop so that ``out[0] == out[-1]`` and
    ``out[0]`` is on-curve."""
    n = len(points)
    if n == 0:
        return np.empty((0, 2), dtype=np.int32)
    prev_on = np.roll(on_curve, 1)          # prev of point i is point i-1 (wrap)
    prev_pts = np.roll(points, 1, axis=0)
    insert_mid = prev_on == on_curve        # midpoint precedes point i

    # Output slot of point i: slot0 reserved iff the wrap point (last) is
    # on-curve; each point occupies 1 slot, plus 1 for its midpoint.
    base = 1 if on_curve[-1] else 0
    sizes = insert_mid.astype(np.int64) + 1
    ends = np.cumsum(sizes) + base          # slot just past point i
    point_slots = ends - 1
    mid_slots = ends - 2                    # only valid where insert_mid

    total = int(ends[-1]) + (0 if on_curve[-1] else 1)
    out = np.empty((total, 2), dtype=np.int32)
    out[point_slots] = points
    if insert_mid.any():
        out[mid_slots[insert_mid]] = _trunc_midpoint(
            prev_pts[insert_mid], points[insert_mid]
        )
    if on_curve[-1]:
        out[0] = out[ends[-1] - 1]          # close: first slot = last point
    else:
        out[-1] = out[0]                    # close: append first point
    return out


def from_simple(desc: ttf.GlyphDescription, data: ttf.SimpleGlyph) -> Glyph:
    """A normalized glyph from a decoded simple glyph. Hinting
    instructions are ignored: the analytic fill does not grid-fit."""
    contours: list[Contour] = []
    start = 0
    for end in data.end_pts_of_contours:
        stop = int(end) + 1
        pts = _normalize_contour(
            data.coordinates[start:stop].astype(np.int32),
            data.on_curve[start:stop],
        )
        contours.append(Contour(pts))
        start = stop
    box = Box(desc.x_min, desc.y_min, desc.x_max, desc.y_max)
    return Glyph(box, tuple(contours))


def _component_transform(
    points: np.ndarray, part: ttf.ComponentPart
) -> np.ndarray:
    """Apply a component's 2.14 transform and offset to int points, with
    TrueType's shift-compensation quirk. For each output axis with matrix
    row ``(m0, m1)`` (raw 2.14 ints) and offset ``e``:

        raw_axis = m0*x + m1*y + max(|m0|,|m1|) * shift
        shift    = 2*e  if ||m0| - |m1|| <= 8  else  e
        value    = raw_axis / 16384

    x' uses (a, c, arg1); y' uses (b, d, arg2). Returns float64 values in
    font units (the caller rounds)."""
    a, b, c, d = (t.data for t in part.transform)
    x = points[:, 0].astype(np.int64)
    y = points[:, 1].astype(np.int64)

    def axis(m0: int, m1: int, e: int) -> np.ndarray:
        tmp = max(abs(m0), abs(m1))
        # wrapped-i16 distance between |m0| and |m1|
        diff = (abs(m0) - abs(m1)) & 0xFFFF
        if diff >= 0x8000:
            diff -= 0x10000
        shift = e * 2 if abs(diff) <= 8 else e
        raw = m0 * x + m1 * y + tmp * shift
        return raw / 16384.0

    return np.stack([axis(a, c, part.argument1), axis(b, d, part.argument2)], axis=1)


def _round_half_away(v: np.ndarray) -> np.ndarray:
    return (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int32)


def from_component(
    desc: ttf.GlyphDescription,
    data: ttf.ComponentGlyph,
    resolve: "dict[int, Glyph]",
) -> Glyph:
    """Flatten a compound glyph into one outline. ``resolve`` maps each
    component's glyph index to its loaded glyph (``Font.load_glyph``
    recurses and guards against cycles)."""
    contours: list[Contour] = []
    for part in data.parts:
        if not part.args_are_xy_values:
            raise NotImplementedError(
                "compound glyph with point-index arguments not implemented"
            )
        part_glyph = resolve[part.glyph_index]
        for contour in part_glyph.contours:
            vals = _component_transform(contour.points, part)
            if part.round_xy_to_grid:
                pts = _round_half_away(vals)
            else:
                pts = vals.astype(np.int32)  # truncate toward zero
                if not np.array_equal(pts.astype(np.float64), vals):
                    log.warning("non-integral component points; rounding")
                    pts = _round_half_away(vals)
            contours.append(Contour(pts))
    box = Box(desc.x_min, desc.y_min, desc.x_max, desc.y_max)
    return Glyph(box, tuple(contours))
