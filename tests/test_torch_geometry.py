"""fontrx_torch.geometry against fontrx.geometry: the port's copy of the
triangulation gives array-equal meshes (vertices, texcoords, triangles, the
three class counts, ``classes`` and ``self_intersecting``) on the ASCII
glyphs of DejaVu Sans, on CJK glyphs whose outlines cross (every one of them
is flagged ``self_intersecting``), and on the hand-made shapes of the JAX
package's own tests (``tests/test_geometry.py``)."""

import logging
import pathlib

import numpy as np
import pytest

from fontrx.font.font import Font as JaxFont
from fontrx.font.glyph import Box as JaxBox
from fontrx.font.glyph import Contour as JaxContour
from fontrx.font.glyph import Glyph as JaxGlyph
from fontrx.geometry import TriangulatedGlyph as JaxMesh
from fontrx.geometry import triangulate as jax_tri
from fontrx_torch.font.font import Font
from fontrx_torch.font.glyph import Box, Contour, Glyph
from fontrx_torch.geometry import TriangulatedGlyph, triangulate_polygon
from fontrx_torch.geometry import triangulate as tri

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEJAVU = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
CJK = ROOT / "tests" / "data" / "cjktest.ttf"
ASCII = [chr(c) for c in range(33, 127)]
CJK_CHARS = [chr(0x4E00 + i) for i in range(32)]


def assert_same_mesh(mesh, want):
    np.testing.assert_array_equal(mesh.vertices, want.vertices)
    np.testing.assert_array_equal(mesh.texcoords, want.texcoords)
    np.testing.assert_array_equal(mesh.triangles, want.triangles)
    np.testing.assert_array_equal(mesh.classes, want.classes)
    assert mesh.vertices.dtype == want.vertices.dtype == np.int32
    assert mesh.texcoords.dtype == want.texcoords.dtype == np.uint8
    assert mesh.triangles.dtype == want.triangles.dtype == np.int32
    assert (mesh.concave_count, mesh.convex_count, mesh.solid_count,
            mesh.self_intersecting) == (want.concave_count, want.convex_count,
                                        want.solid_count, want.self_intersecting)


def meshes(path, chars):
    font, jax_font = Font.open(path), JaxFont.open(str(path))
    return [(TriangulatedGlyph.from_glyph(font.get_glyph(c)[0]),
             JaxMesh.from_glyph(jax_font.get_glyph(c)[0])) for c in chars]


def test_ascii_glyphs():
    pairs = meshes(DEJAVU, ASCII)
    for mesh, want in pairs:
        assert_same_mesh(mesh, want)
    assert sum(len(m.triangles) for m, _ in pairs) == 2604
    assert not any(m.self_intersecting for m, _ in pairs)


def test_cjk_glyphs(caplog):
    """32 CJK glyphs, all with crossing outlines, up to 446 triangles."""
    with caplog.at_level(logging.ERROR):
        pairs = meshes(CJK, CJK_CHARS)
    for mesh, want in pairs:
        assert_same_mesh(mesh, want)
    assert all(m.self_intersecting for m, _ in pairs)
    assert max(len(m.triangles) for m, _ in pairs) == 446


def sq(size=10, rev=False):
    pts = [(0, 0, 0), (size, 0, 1), (size, size, 2), (0, size, 3)]
    return pts[::-1] if rev else pts


SHAPES = {
    "square": (sq(10), []),
    "square_reversed": (sq(10, rev=True), []),
    "concave": ([(0, 0, 0), (20, 0, 1), (20, 10, 2), (10, 10, 3), (10, 20, 4), (0, 20, 5)], []),
    "square_with_hole": ([(0, 0, 0), (30, 0, 1), (30, 30, 2), (0, 30, 3)],
                         [[(10, 10, 4), (20, 10, 5), (20, 20, 6), (10, 20, 7)]]),
    "degenerate": ([(0, 0, 0), (1, 1, 1)], []),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_triangulate_polygon(name):
    outer, holes = SHAPES[name]
    assert triangulate_polygon(outer, holes) == jax_tri.triangulate_polygon(outer, holes)


@pytest.mark.parametrize("poly", [sq(10), sq(10, rev=True), SHAPES["concave"][0]])
def test_primitives(poly):
    assert tri.signed_area2(poly) == jax_tri.signed_area2(poly)
    for x, y in [(5, 5), (15, 5), (-1, 5), (0, 0), (10, 5), (5, 10)]:
        assert tri.point_in_polygon(x, y, poly) == jax_tri.point_in_polygon(x, y, poly)
    ccw = poly if tri.signed_area2(poly) > 0 else poly[::-1]
    assert tri.ear_clip(ccw) == jax_tri.ear_clip(ccw)


A, B = (0, 0, 0), (10, 10, 1)
CROSSINGS = {
    "x_cross": (A, B, (0, 10, 2), (10, 0, 3), True),
    "shared_end": (A, B, B, (0, 10, 2), False),
    "t_junction": (A, B, (5, 5, 4), (20, 5, 5), False),
    "collinear": (A, B, (2, 2, 4), (8, 8, 5), False),
}


@pytest.mark.parametrize("name", sorted(CROSSINGS))
def test_segments_cross_strictly(name):
    *segs, want = CROSSINGS[name]
    assert tri._segments_cross_strictly(*segs) == want
    assert jax_tri._segments_cross_strictly(*segs) == want
    assert tri._segments_properly_intersect(*segs) == jax_tri._segments_properly_intersect(*segs)


def bowtie_points():
    """The JAX package's figure-8 (``tests/test_geometry.py``): straight
    segments with midpoint controls."""
    corners = [(0, 0), (100, 100), (100, 0), (0, 100)]
    pts = []
    for i, c in enumerate(corners):
        nxt = corners[(i + 1) % 4]
        pts.append(c)
        pts.append(((c[0] + nxt[0]) // 2, (c[1] + nxt[1]) // 2))
    pts.append(corners[0])
    return np.array(pts, np.int32)


def test_bowtie_flagged(caplog):
    pts = bowtie_points()
    with caplog.at_level(logging.ERROR):
        mesh = TriangulatedGlyph.from_glyph(Glyph(Box(0, 0, 100, 100), (Contour(pts),)))
        want = JaxMesh.from_glyph(JaxGlyph(JaxBox(0, 0, 100, 100), (JaxContour(pts),)))
    assert mesh.self_intersecting
    assert_same_mesh(mesh, want)


def test_empty_glyph():
    assert_same_mesh(TriangulatedGlyph.from_glyph(Glyph.empty()),
                     JaxMesh.from_glyph(JaxGlyph.empty()))
