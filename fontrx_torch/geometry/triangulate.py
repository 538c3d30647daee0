"""Polygon triangulation: ear clipping with hole bridging.

A copy of ``fontrx/geometry/triangulate.py``, with the standard library's
``logging`` for the package's logger. ``tests/test_torch_geometry.py``
holds it equal to the original.

Triangulates the glyph-interior polygon (outer contour + holes) into
solid triangles.  Integer-exact orientation/containment predicates
(int64 cross products), O(n^2) ear search — glyph polygons are small
(tens to low hundreds of vertices), so robustness beats asymptotics.

Replaces the reference's sweep-line triangulation
(``src/tools/geometry.zig:46-398``) with a different algorithm; see
package docstring for why.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)

Vertex = tuple[int, int, int]  # (x, y, external index)


def _cross(o: Vertex, a: Vertex, b: Vertex) -> int:
    """z of (a-o) x (b-o), exact."""
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


def signed_area2(poly: list[Vertex]) -> int:
    """Twice the signed area; > 0 for counter-clockwise (y up)."""
    s = 0
    n = len(poly)
    for i in range(n):
        x0, y0, _ = poly[i]
        x1, y1, _ = poly[(i + 1) % n]
        s += x0 * y1 - x1 * y0
    return s


def point_in_polygon(x: int, y: int, poly: list[Vertex]) -> bool:
    """Even-odd ray crossing (used only for hole->outer nesting)."""
    inside = False
    n = len(poly)
    for i in range(n):
        x0, y0, _ = poly[i]
        x1, y1, _ = poly[(i + 1) % n]
        if (y0 > y) != (y1 > y):
            # exact rational comparison: x < x0 + (y-y0)(x1-x0)/(y1-y0)
            t_num = (y - y0) * (x1 - x0)
            dy = y1 - y0
            lhs = (x - x0) * dy
            if (lhs < t_num) if dy > 0 else (lhs > t_num):
                inside = not inside
    return inside


def _segments_properly_intersect(p1, p2, q1, q2) -> bool:
    """True if segments p1p2 and q1q2 cross or graze (exact integer).

    NOTE: an endpoint of one segment lying ON the other counts as an
    intersection here — that is what ``_bridge_hole``'s visibility test
    wants (a bridge grazing a vertex is not visible); it skips
    shared-endpoint pairs explicitly before calling.  For strict
    interior crossings use :func:`_segments_cross_strictly`."""
    d1 = _cross(q1, q2, p1)
    d2 = _cross(q1, q2, p2)
    d3 = _cross(p1, p2, q1)
    d4 = _cross(p1, p2, q2)
    if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)) and d1 != d2 and d3 != d4:
        return True
    return False


def _segments_cross_strictly(p1, p2, q1, q2) -> bool:
    """True only when the segment *interiors* cross (exact integer):
    both endpoints of each segment strictly on opposite sides of the
    other.  Endpoint touching, T-junctions, and collinear overlap do
    not count — adjacent contour edges sharing a vertex never trip."""
    d1 = _cross(q1, q2, p1)
    d2 = _cross(q1, q2, p2)
    d3 = _cross(p1, p2, q1)
    d4 = _cross(p1, p2, q2)
    return (
        ((d1 > 0 and d2 < 0) or (d1 < 0 and d2 > 0))
        and ((d3 > 0 and d4 < 0) or (d3 < 0 and d4 > 0))
    )


def _point_in_triangle(p: Vertex, a: Vertex, b: Vertex, c: Vertex) -> bool:
    """Closed containment for a CCW triangle (boundary counts)."""
    return _cross(a, b, p) >= 0 and _cross(b, c, p) >= 0 and _cross(c, a, p) >= 0


def contours_self_intersect(polys: list[list[Vertex]]) -> bool:
    """Exact detector for crossing interior-polygon edges (within a
    contour or across contours of the same glyph).

    The reference's triangulation is known-broken on self-intersecting
    contours: its crossing-splitting preprocessor is float-based and
    disabled (``geometry.zig:74-127`` commented out at
    ``TriangulatedGlyph.zig:120``; README TODO "fix wrong glyph
    triangulation").  Rather than split at crossings — which forces
    rounding new vertices to the integer grid, the very caveat that got
    the reference's pass disabled — we *detect* exactly (int64 cross
    products) and let callers fall back to the winding fill, which
    handles self-intersection natively via the nonzero rule.

    O(E^2) over chord edges; glyph polygons are small (tens to low
    hundreds of edges), so exactness beats asymptotics, as elsewhere in
    this module.
    """
    edges: list[tuple[Vertex, Vertex]] = []
    for poly in polys:
        n = len(poly)
        for i in range(n):
            a, b = poly[i], poly[(i + 1) % n]
            if a[:2] != b[:2]:
                edges.append((a, b))
    for i in range(len(edges)):
        a1, a2 = edges[i]
        for j in range(i + 1, len(edges)):
            b1, b2 = edges[j]
            if _segments_cross_strictly(a1, a2, b1, b2):
                return True
    return False


def _bridge_hole(outer: list[Vertex], hole: list[Vertex]) -> list[Vertex]:
    """Merge one hole into the outer polygon with a two-way bridge edge.

    Picks the hole's rightmost vertex and the closest outer vertex whose
    connecting segment crosses no outer/hole edge (brute-force
    visibility — exact and adequate at glyph scale).
    """
    hi = max(range(len(hole)), key=lambda i: (hole[i][0], hole[i][1]))
    h = hole[hi]

    def visible(v: Vertex) -> bool:
        for poly in (outer, hole):
            n = len(poly)
            for i in range(n):
                a, b = poly[i], poly[(i + 1) % n]
                if a in (v, h) or b in (v, h):
                    continue
                if _segments_properly_intersect(h, v, a, b):
                    return False
        return True

    candidates = sorted(
        range(len(outer)),
        key=lambda i: (outer[i][0] - h[0]) ** 2 + (outer[i][1] - h[1]) ** 2,
    )
    for vi in candidates:
        if visible(outer[vi]):
            rotated = hole[hi:] + hole[:hi]
            return outer[: vi + 1] + [hole[hi]] + rotated[1:] + [hole[hi], outer[vi]] + outer[vi + 1 :]
    log.warning("hole bridging failed; dropping hole")
    return outer


def ear_clip(poly: list[Vertex]) -> list[tuple[int, int, int]]:
    """Ear-clip a CCW simple polygon (bridged, possibly with duplicate
    bridge vertices) into triangles of external indices (CCW)."""
    verts = list(poly)
    tris: list[tuple[int, int, int]] = []
    guard = 0
    while len(verts) > 3 and guard < 10 * len(poly) ** 2:
        n = len(verts)
        clipped = False
        for i in range(n):
            a, b, c = verts[(i - 1) % n], verts[i], verts[(i + 1) % n]
            if _cross(a, b, c) <= 0:  # reflex or collinear — not an ear
                continue
            # no other vertex inside the candidate ear
            ok = True
            for v in verts:
                if v in (a, b, c):
                    continue
                if _point_in_triangle(v, a, b, c):
                    ok = False
                    break
            if ok:
                tris.append((a[2], b[2], c[2]))
                del verts[i]
                clipped = True
                break
        guard += 1
        if not clipped:
            # degenerate input (self-intersection) — drop a collinear
            # vertex and continue; graceful degradation in the spirit of
            # the reference's own known triangulation limitation
            best = min(range(len(verts)), key=lambda i: abs(
                _cross(verts[(i - 1) % len(verts)], verts[i], verts[(i + 1) % len(verts)])
            ))
            log.debug("no ear found; dropping vertex %d", best)
            del verts[best]
    if len(verts) == 3:
        if _cross(verts[0], verts[1], verts[2]) > 0:
            tris.append((verts[0][2], verts[1][2], verts[2][2]))
    return tris


def triangulate_polygon(
    outer: list[Vertex], holes: list[list[Vertex]]
) -> list[tuple[int, int, int]]:
    """Triangulate a polygon with holes.

    ``outer`` in any orientation (normalized to CCW); ``holes``
    likewise (normalized to CW).  Returns triangles of external vertex
    indices in **clockwise** order, matching the reference's emitted
    winding (``geometry.zig:391-397``).
    """
    if len(outer) < 3:
        return []
    if signed_area2(outer) < 0:
        outer = outer[::-1]
    merged = outer
    # bridge holes right-to-left so earlier bridges don't occlude later ones
    for hole in sorted(holes, key=lambda hl: -max(v[0] for v in hl)):
        if len(hole) < 3:
            continue
        if signed_area2(hole) > 0:
            hole = hole[::-1]
        merged = _bridge_hole(merged, hole)
    tris = ear_clip(merged)
    return [(a, c, b) for a, b, c in tris]  # flip to clockwise
