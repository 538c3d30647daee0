"""Glyph -> classified triangle mesh (the Loop-Blinn-style geometry).

A copy of ``fontrx/geometry/triangulated_glyph.py`` on the port's
``fontrx_torch.font.glyph.Glyph``. ``tests/test_torch_geometry.py`` holds
it equal to the original.

Behavioral equivalent of ``src/tools/TriangulatedGlyph.zig``: each
quadratic segment classifies by the exact integer cross product
``(p1-p0) x (p2-p0)`` —

- ``< 0`` (clockwise)          => **convex** curve triangle
  ``(p0, p2, p1)``; interior polygon follows the chord ``p0-p2``
- ``== 0`` (collinear)         => straight line; chord only
- ``> 0`` (counter-clockwise)  => **concave** curve triangle
  ``(p0, p1, p2)``; interior polygon passes through the control point

(``TriangulatedGlyph.zig:75-96``).  On-curve vertices get alternating
texcoords (1,0)/(0,1) by segment parity and controls get (0,0)
(``:99-115``) — these drive the fragment implicit test
``(1+u-v)^2 <> 4u`` (``shader.slang:32-45``).  The triangle list is
ordered ``[concave...][convex...][solid...]`` with counts, exactly like
the reference's index buffer.

The interior is triangulated per outer-contour group (holes assigned by
exact point-in-polygon nesting) by ``fontrx_torch.geometry.triangulate``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from fontrx_torch.font.glyph import Glyph
from fontrx_torch.geometry.triangulate import (
    Vertex,
    contours_self_intersect,
    point_in_polygon,
    signed_area2,
    triangulate_polygon,
)
log = logging.getLogger(__name__)

CLASS_CONCAVE = 0
CLASS_CONVEX = 1
CLASS_SOLID = 2


@dataclass(frozen=True, slots=True)
class TriangulatedGlyph:
    """GPU-style mesh: positions, texcoords, classified triangles."""

    vertices: np.ndarray   # int32 [N, 2]
    texcoords: np.ndarray  # uint8 [N, 2]
    triangles: np.ndarray  # int32 [M, 3], ordered [concave][convex][solid]
    concave_count: int
    convex_count: int
    solid_count: int
    # exact-detected crossing contour edges: the interior mesh is
    # best-effort and may fill the wrong region (the reference's own
    # acknowledged failure mode) — renderers should fall back to the
    # winding fill (see ``triangulate.contours_self_intersect``)
    self_intersecting: bool = False

    @property
    def classes(self) -> np.ndarray:
        return np.concatenate([
            np.full(self.concave_count, CLASS_CONCAVE, np.int32),
            np.full(self.convex_count, CLASS_CONVEX, np.int32),
            np.full(self.solid_count, CLASS_SOLID, np.int32),
        ])

    @classmethod
    def from_glyph(cls, glyph: Glyph) -> "TriangulatedGlyph":
        vertices: list[tuple[int, int]] = []
        texcoords: list[tuple[int, int]] = []
        concave: list[tuple[int, int, int]] = []
        convex: list[tuple[int, int, int]] = []
        contour_polys: list[list[Vertex]] = []

        for contour in glyph.contours:
            pts = contour.points
            count = len(pts) // 2
            poly: list[Vertex] = []
            for k in range(count):
                p0 = tuple(int(v) for v in pts[2 * k])
                p1 = tuple(int(v) for v in pts[2 * k + 1])
                p2 = tuple(int(v) for v in pts[2 * k + 2])
                i0 = len(vertices)

                cross = (p1[0] - p0[0]) * (p2[1] - p0[1]) - (p1[1] - p0[1]) * (
                    p2[0] - p0[0]
                )
                if cross < 0:  # clockwise => convex curve
                    convex.append((i0, i0 + 2, i0 + 1))
                    poly.append((p0[0], p0[1], i0))
                elif cross > 0:  # counter-clockwise => concave curve
                    concave.append((i0, i0 + 1, i0 + 2))
                    poly.append((p0[0], p0[1], i0))
                    poly.append((p1[0], p1[1], i0 + 1))
                else:  # straight line
                    poly.append((p0[0], p0[1], i0))

                y_axis = k & 1 != 0
                vertices.append(p0)
                texcoords.append((0, 1) if y_axis else (1, 0))
                vertices.append(p1)
                texcoords.append((0, 0))
            # closing on-curve point
            y_axis = count & 1 != 0
            vertices.append(tuple(int(v) for v in pts[-1]))
            texcoords.append((0, 1) if y_axis else (1, 0))
            if poly:
                contour_polys.append(poly)

        crossing = contours_self_intersect(contour_polys)
        if crossing:
            log.warning(
                "glyph outline self-intersects: interior triangulation is "
                "best-effort; render via the winding fill for a correct "
                "result (reference limitation: geometry.zig:74-127)"
            )
        solid = _triangulate_interior(contour_polys)

        tris = concave + convex + solid
        return cls(
            vertices=np.array(vertices, np.int32).reshape(-1, 2),
            texcoords=np.array(texcoords, np.uint8).reshape(-1, 2),
            triangles=np.array(tris, np.int32).reshape(-1, 3),
            concave_count=len(concave),
            convex_count=len(convex),
            solid_count=len(solid),
            self_intersecting=crossing,
        )


def _triangulate_interior(
    polys: list[list[Vertex]],
) -> list[tuple[int, int, int]]:
    """Group contours into (outer, holes) by nesting depth, then
    triangulate each group.

    TrueType convention: outer contours wind clockwise in y-up font
    space (negative signed area), holes counter-clockwise; nesting is
    verified with an exact containment test so decorative fonts with
    odd orientations still group sanely.
    """
    if not polys:
        return []
    # nesting depth of each contour = number of other contours containing it
    depths = []
    for i, poly in enumerate(polys):
        x, y, _ = poly[0]
        depth = sum(
            1
            for j, other in enumerate(polys)
            if j != i and point_in_polygon(x, y, other)
        )
        depths.append(depth)

    solid: list[tuple[int, int, int]] = []
    outers = [i for i, d in enumerate(depths) if d % 2 == 0]
    for oi in outers:
        holes = [
            polys[j]
            for j, d in enumerate(depths)
            if d == depths[oi] + 1
            and point_in_polygon(polys[j][0][0], polys[j][0][1], polys[oi])
        ]
        solid.extend(triangulate_polygon(polys[oi], holes))
    return solid
