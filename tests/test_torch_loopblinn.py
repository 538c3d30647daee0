"""fontrx_torch Loop-Blinn fill: the plain PyTorch version against the JAX
package's jnp version and its TPU kernel (K12, in interpret mode) on BASELINE
config 3's atlas, the wrapper's CPU route and ``loopblinn_fill``, the tie
cases, the mesh fill against the port's winding fill, the bound's count, and
the CUDA kernel against the plain version on the card.

Tolerance everywhere: 0 differing pixels. The JAX package's jnp version, its
Pallas kernel and a strict float32 program agree on every pixel of config
3's atlas, so the port is held to them bit for bit (no edge-tolerant
comparison).

The module imports JAX only inside the tests that compare with it, so the
card's tests also run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_loopblinn.py``.
"""

import logging
import pathlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from fontrx_torch import bound
from fontrx_torch.convert import triangles_to_device
from fontrx_torch.font.font import Font
from fontrx_torch.geometry import TriangulatedGlyph
from fontrx_torch.kernels import _build, loopblinn, loopblinn_ref, winding_ref
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import glyph_segments

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEJAVU = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
CJK = ROOT / "tests" / "data" / "cjktest.ttf"
ASCII = [chr(c) for c in range(33, 127)]
CJK_CHARS = [chr(0x4E00 + i) for i in range(32)]
f32 = np.float32


@pytest.fixture(scope="module")
def dejavu():
    return Font.open(DEJAVU)


@pytest.fixture
def one_torch_thread():
    """Torch on one thread: with one per core, parallel test workers spin
    against each other (``tests/test_torch_sharding.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def box_of(glyph):
    return (glyph.box.x_min, glyph.box.y_min, glyph.box.x_max, glyph.box.y_max)


def mesh_batch(font, chars, size, tile):
    """Triangulate ``chars`` and pad them to one triangle count as
    ``benchmarks/configs.py:152-176`` does, on fixed ``tile`` grids:
    ``(tris, classes, min_x, max_y, scale)`` as NumPy."""
    glyphs = [font.get_glyph(c)[0] for c in chars]
    tris, classes = loopblinn.pack_meshes([TriangulatedGlyph.from_glyph(g) for g in glyphs])
    grids = [RasterGrid.fixed_tile(box_of(g), size, font.info.units_per_em, tile)
             for g in glyphs]
    min_x = np.array([g.min_x for g in grids], np.int32)
    max_y = np.array([g.max_y for g in grids], np.int32)
    return tris, classes, min_x, max_y, f32(grids[0].scale)


@pytest.fixture(scope="module")
def config3(dejavu):
    """BASELINE config 3: the 94 printable ASCII glyphs at 128 px, 128 x 128."""
    return mesh_batch(dejavu, ASCII, 128, 128)


def tensors(tris, classes, min_x, max_y, scale, device="cpu"):
    return (torch.from_numpy(tris).to(device), torch.from_numpy(classes).to(device),
            torch.from_numpy(min_x).to(device), torch.from_numpy(max_y).to(device),
            float(scale))


def port_ref(batch, h, w, offset=(0.0, 0.0)):
    return loopblinn_ref.loopblinn_batch(*tensors(*batch), height=h, width=w,
                                         sample_offset=offset).numpy()


def jax_args(batch):
    import jax.numpy as jnp

    tris, classes, min_x, max_y, scale = batch
    return (jnp.asarray(tris), jnp.asarray(classes), jnp.asarray(min_x),
            jnp.asarray(max_y), jnp.float32(scale))


class TestRefVsJax:
    def test_config3_atlas(self, config3):
        """Every pixel of config 3's atlas: 94 glyphs, 2604 triangles padded
        to 126, 190,472 covered pixels."""
        from fontrx.kernels.loopblinn import loopblinn_batch

        tris, classes = config3[:2]
        assert tris.shape == (94, 126, 3, 4) and int((classes != 3).sum()) == 2604
        want = np.asarray(loopblinn_batch(*jax_args(config3), height=128, width=128))
        out = port_ref(config3, 128, 128)
        assert out.dtype == np.bool_ and out.shape == (94, 128, 128)
        assert int(want.sum()) == 190472
        np.testing.assert_array_equal(out, want)

    def test_pallas_interpret(self, config3):
        """12 glyphs of the atlas against K12 itself, in interpret mode."""
        from fontrx.kernels.loopblinn import loopblinn_pallas_batch

        batch = tuple(a[::8] for a in config3[:4]) + (config3[4],)
        assert len(batch[0]) == 12
        want = np.asarray(loopblinn_pallas_batch(*jax_args(batch), height=128, width=128,
                                                 interpret=True))
        np.testing.assert_array_equal(port_ref(batch, 128, 128), want)

    @pytest.mark.parametrize("offset", [(0.0, 0.0), (1 / 3, 1 / 3)])
    def test_sample_offset(self, dejavu, offset):
        from fontrx.kernels.loopblinn import loopblinn_batch

        batch = mesh_batch(dejavu, "AQg@&%", 40, 44)
        want = np.asarray(loopblinn_batch(*jax_args(batch), height=44, width=44,
                                          sample_offset=offset))
        np.testing.assert_array_equal(port_ref(batch, 44, 44, offset), want)

    @pytest.mark.parametrize("ch", ["g", "@", "O", "%"])
    def test_fill(self, ch):
        """``loopblinn_fill(device="cpu")`` against the JAX package's
        ``loopblinn_fill(backend="jnp")``, each on its own package's mesh."""
        from fontrx.font.font import Font as JaxFont
        from fontrx.geometry import TriangulatedGlyph as JaxMesh
        from fontrx.kernels.grid import RasterGrid as JaxGrid
        from fontrx.kernels.loopblinn import loopblinn_fill as jax_fill

        font, jax_font = Font.open(DEJAVU), JaxFont.open(str(DEJAVU))
        glyph = font.get_glyph(ch)[0]
        grid = RasterGrid.for_glyph_box(box_of(glyph), 48, font.info.units_per_em)
        jgrid = JaxGrid.for_glyph_box(box_of(glyph), 48, font.info.units_per_em)
        out = loopblinn.loopblinn_fill(TriangulatedGlyph.from_glyph(glyph), grid, device="cpu")
        want = jax_fill(JaxMesh.from_glyph(jax_font.get_glyph(ch)[0]), jgrid, backend="jnp")
        assert out.dtype == np.uint8 and out.shape == (grid.height, grid.width)
        np.testing.assert_array_equal(out, want)


# Tie cases at scale 1 from integer vertices (twice the area 64, so 1/area is
# exact): pixel (r, c) samples (c - 2, 10 - r), and every edge function,
# weight, u, v and f is exact. Triangles, one a glyph, with their classes:
A, B, C = (0, 0), (8, 0), (8, 8)
TIE_MESHES = [
    ([(0, 0, 0, 0), (8, 0, 0, 0), (0, 8, 0, 0)], 2),   # solid, counter-clockwise
    ([(0, 0, 0, 0), (0, 8, 0, 0), (8, 0, 0, 0)], 2),   # solid, clockwise: e*sgn = -0.0 on edges
    ([(*A, 1, 0), (*B, 0, 0), (*C, 0, 1)], 0),         # concave curve
    ([(*A, 1, 0), (*B, 0, 0), (*C, 0, 1)], 1),         # convex curve
    ([(*A, 1, 0), (*C, 0, 0), (*B, 0, 1)], 0),         # concave, clockwise
    ([(0, 0, 0, 0), (8, 0, 0, 0), (0, 8, 0, 0)], 3),   # padding class with an area
    ([(0, 0, 0, 0), (4, 4, 0, 0), (8, 8, 0, 0)], 2),   # solid with area 0
    ([(0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0)], 3),   # all-zero padding
]
TIE_H = TIE_W = 12


def tie_batch():
    tris = np.array([m for m, _ in TIE_MESHES], f32)[:, None]  # [8, 1, 3, 4]
    classes = np.array([c for _, c in TIE_MESHES], np.int32)[:, None]
    n = len(TIE_MESHES)
    return tris, classes, np.full(n, -2, np.int32), np.full(n, 10, np.int32), f32(1)


def exact_cover(mesh, cls):
    """The Loop-Blinn function in exact rational arithmetic."""
    (ax, ay, u0, v0), (bx, by, u1, v1), (cx, cy, u2, v2) = mesh
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    out = np.zeros((TIE_H, TIE_W), bool)
    for r in range(TIE_H):
        for c in range(TIE_W):
            px, py = c - 2, 10 - r
            e0 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
            e1 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
            e2 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
            if area == 0 or min(e0 * area, e1 * area, e2 * area) < 0:
                continue
            la, lb = Fraction(e1, area), Fraction(e2, area)
            lc = 1 - la - lb
            u, v = la * u0 + lb * u1 + lc * u2, la * v0 + lb * v1 + lc * v2
            f = (1 + u - v) ** 2
            out[r, c] = {0: f >= 4 * u, 1: f <= 4 * u, 2: True}.get(cls, False)
    return out


def tie_expected():
    return np.stack([exact_cover(m, c) for m, c in TIE_MESHES])


class TestTies:
    def test_exact_function(self):
        np.testing.assert_array_equal(port_ref(tie_batch(), TIE_H, TIE_W), tie_expected())

    def test_ties_drawn(self):
        out = port_ref(tie_batch(), TIE_H, TIE_W)
        # the vertices and edge pixels of both solid triangles
        for g in (0, 1):
            assert out[g, 10, 2] and out[g, 10, 10] and out[g, 2, 2] and out[g, 6, 6]
        # f == 4u at the on-curve corners (A and C, or A and B for the
        # clockwise one): both curve classes keep them
        for g in (2, 3):
            assert out[g, 10, 2] and out[g, 2, 10]
        assert out[4, 10, 2] and out[4, 10, 10]
        # padding and area 0 never draw
        assert not out[5:].any()

    def test_jax_agrees(self):
        from fontrx.kernels.loopblinn import loopblinn_batch

        want = np.asarray(loopblinn_batch(*jax_args(tie_batch()), height=TIE_H, width=TIE_W))
        np.testing.assert_array_equal(want, tie_expected())

    def test_nan_never_draws(self):
        """A NaN coordinate: ``jnp.sign`` keeps the NaN (``torch.sign`` would
        give 0 and draw)."""
        tris, classes, min_x, max_y, scale = tie_batch()
        tris[:2, 0, 1, 0] = np.nan
        out = port_ref((tris, classes, min_x, max_y, scale), TIE_H, TIE_W)
        assert not out[:2].any()


def test_atlas_against_winding(dejavu, config3):
    """On config 3's whole atlas at the tie-free offset (1/3, 1/3), the mesh
    fill differs from the winding fill at two pixels, one of '*' and one of
    'X', in the JAX package's jnp version as in the port: a property of the
    triangulated fill, not of the port."""
    from fontrx.kernels.loopblinn import loopblinn_batch

    from fontrx_torch.engine.atlas import pack_charset

    off = (1 / 3, 1 / 3)
    batch = pack_charset(dejavu, list(range(33, 127)))
    fill = port_ref(config3, 128, 128, off)
    w = winding_ref.winding_batch(torch.from_numpy(batch.segments), *tensors(*config3)[2:],
                                  height=128, width=128, sample_offset=off).numpy()
    pick = [ASCII.index("*"), ASCII.index("X")]
    diff = np.argwhere(fill != (w != 0)).tolist()
    assert diff == [[pick[0], 36, 11], [pick[1], 26, 48]]
    two = tuple(a[pick] for a in config3[:4]) + (config3[4],)
    want = np.asarray(loopblinn_batch(*jax_args(two), height=128, width=128,
                                      sample_offset=off))
    np.testing.assert_array_equal(fill[pick], want)


@pytest.mark.parametrize("ch", list("AOBg8@&WQ%"))
def test_fill_matches_winding(dejavu, ch):
    """The port's version of the JAX package's test
    (``tests/test_geometry.py::test_fill_matches_winding``): the mesh fill
    equals the port's own winding fill at tie-free sample offsets."""
    glyph = dejavu.get_glyph(ch)[0]
    mesh = TriangulatedGlyph.from_glyph(glyph)
    grid = RasterGrid.for_glyph_box(box_of(glyph), 64, dejavu.info.units_per_em)
    off = (1 / 3, 1 / 3)
    args = triangles_to_device(*loopblinn.pack_meshes([mesh]), [grid], "cpu")
    fill = loopblinn.loopblinn_batch(*args, height=grid.height, width=grid.width,
                                     sample_offset=off)
    w = winding_ref.winding_batch(torch.from_numpy(glyph_segments(glyph))[None], *args[2:],
                                  height=grid.height, width=grid.width, sample_offset=off)
    assert torch.equal(fill, w != 0)


class TestWrapper:
    def test_cpu_route(self, config3):
        batch = tuple(a[:3] for a in config3[:4]) + (config3[4],)
        before = loopblinn.launches
        out = loopblinn.loopblinn_batch(*tensors(*batch), height=128, width=128)
        assert loopblinn.launches == before and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), port_ref(batch, 128, 128))

    def test_fill_defaults_to_the_card(self, dejavu):
        glyph = dejavu.get_glyph("g")[0]
        mesh = TriangulatedGlyph.from_glyph(glyph)
        grid = RasterGrid.for_glyph_box(box_of(glyph), 32, dejavu.info.units_per_em)
        if torch.cuda.is_available():
            before = loopblinn.launches
            out = loopblinn.loopblinn_fill(mesh, grid)
            assert loopblinn.launches == before + 1
            np.testing.assert_array_equal(out, loopblinn.loopblinn_fill(mesh, grid, "cpu"))
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                loopblinn.loopblinn_fill(mesh, grid)

    def test_pad_triangles(self):
        tris = np.arange(24, dtype=f32).reshape(2, 3, 4)
        padded, cls = loopblinn.pad_triangles(tris, np.array([0, 2], np.int32), 4)
        assert padded.shape == (4, 3, 4) and cls.tolist() == [0, 2, 3, 3]
        np.testing.assert_array_equal(padded[:2], tris)
        assert not padded[2:].any()

    def test_pack_meshes(self, dejavu):
        """Each row holds its mesh's corners as (x, y, u, v) in triangle
        order, then class-3 zero rows up to the largest mesh."""
        meshes = [TriangulatedGlyph.from_glyph(dejavu.get_glyph(c)[0]) for c in "i.B"]
        tris, classes = loopblinn.pack_meshes(meshes)
        cap = max(len(m.triangles) for m in meshes)
        assert (tris.dtype, classes.dtype) == (f32, np.int32)
        assert tris.shape == (3, cap, 3, 4) and classes.shape == (3, cap)
        for i, m in enumerate(meshes):
            n = len(m.triangles)
            np.testing.assert_array_equal(tris[i, :n, :, :2], m.vertices[m.triangles])
            np.testing.assert_array_equal(tris[i, :n, :, 2:], m.texcoords[m.triangles])
            np.testing.assert_array_equal(classes[i, :n], m.classes)
            assert not tris[i, n:].any() and (classes[i, n:] == 3).all()

    def test_triangles_to_device(self, dejavu):
        glyph = dejavu.get_glyph("b")[0]
        grid = RasterGrid.for_glyph_box(box_of(glyph), 24, dejavu.info.units_per_em)
        mesh = TriangulatedGlyph.from_glyph(glyph)
        tris, cls, min_x, max_y, scale = triangles_to_device(
            *loopblinn.pack_meshes([mesh]), [grid], "cpu")
        assert (tris.dtype, cls.dtype, min_x.dtype, max_y.dtype) == (
            torch.float32, torch.int32, torch.int32, torch.int32)
        assert tuple(tris.shape) == (1, len(mesh.triangles), 3, 4)
        assert (int(min_x[0]), int(max_y[0]), scale) == (grid.min_x, grid.max_y, grid.scale)

    @pytest.mark.parametrize("b,m,h,w", [(0, 4, 5, 7), (2, 0, 5, 7), (2, 4, 0, 7)])
    def test_empty(self, b, m, h, w):
        out = loopblinn.loopblinn_batch(
            torch.zeros((b, m, 3, 4)), torch.full((b, m), 3, dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32), torch.zeros(b, dtype=torch.int32), 1.0,
            height=h, width=w)
        assert tuple(out.shape) == (b, h, w) and out.dtype == torch.bool and not out.any()


class TestBound:
    def test_work_by_hand(self):
        """10 operations per triangle that can draw (classes 0-2: the first
        five meshes and the area-0 one), 19 per inside pair of a curve
        triangle, none per pair of a solid one."""
        ops, pairs = bound.loopblinn_work(*tensors(*tie_batch()), height=TIE_H, width=TIE_W)
        # inside pairs, whatever the class (class 2 draws every inside pixel)
        inside = [int(exact_cover(mesh, 2).sum()) for mesh, _ in TIE_MESHES]
        assert pairs == sum(inside)
        curve = sum(n for n, (_, cls) in zip(inside, TIE_MESHES) if cls in (0, 1))
        assert ops == 6 * bound.LB_TRIANGLE_SETUP + curve * bound.LB_CURVE_PAIR

    def test_bytes_by_hand(self):
        """52 B per triangle that can draw (an area-0 one too: its area
        is known only from its coordinates), 4 B per padding row, 8 B of
        anchors per glyph, 1 B per pixel."""
        classes = torch.tensor([[0, 1, 2, 3], [2, 3, 3, 3]], dtype=torch.int32)
        assert bound.loopblinn_bytes(classes, 5, 7) == 4 * 52 + 4 * 4 + 2 * 8 + 2 * 35

    def test_config3_counts(self, config3):
        """Config 3's atlas: 201,994 inside pairs for its 190,472 covered
        pixels (a pixel on a shared edge lies in two triangles), 495,150
        operations (the counts ``chip_smoke.py`` prints on the card), and
        1,713,216 B: 2,604 live triangles x 52 B, 9,240 padding classes x
        4 B, 94 x 8 B of anchors and 94 x 128 x 128 B of output."""
        ops, pairs = bound.loopblinn_work(*tensors(*config3), height=128, width=128)
        assert (ops, pairs) == (495150, 201994)
        classes = config3[1]
        assert (classes.shape, int((classes != 3).sum())) == ((94, 126), 2604)
        assert bound.loopblinn_bytes(classes, 128, 128) == 1713216


def slivers(rng, b=4, m=300, h=80, w=72, scale=f32(0.0625), offset=(0.0, 0.0)):
    """Thin random triangles along sample columns and rows next to 16 x 16
    tile edges: two corners at the sample points of two pixels of one column
    (or row) beside a tile edge, the third on the line through them, or a
    float32 step off it. Random classes (0-3) and texcoords."""
    near_c = [k + d for k in range(0, w + 1, 16) for d in (-1, 0, 1) if 0 <= k + d < w]
    near_r = [k + d for k in range(0, h + 1, 16) for d in (-1, 0, 1) if 0 <= k + d < h]
    min_x = rng.integers(-40, 40, b).astype(np.int32)
    max_y = rng.integers(40, 120, b).astype(np.int32)
    tris = np.zeros((b, m, 3, 4), f32)
    for g in range(b):
        c = rng.integers(0, w, (m, 2))
        r = rng.integers(0, h, (m, 2))
        vert = rng.random(m) < 0.5
        c[vert] = rng.choice(near_c, vert.sum())[:, None]
        r[~vert] = rng.choice(near_r, (~vert).sum())[:, None]
        x = ((min_x[g] + c).astype(f32) + f32(offset[0])) / scale
        y = ((max_y[g] - r).astype(f32) + f32(offset[1])) / scale
        k = rng.uniform(-1.5, 2.5, m).astype(f32)
        tx = x[:, 0] + k * (x[:, 1] - x[:, 0])
        ty = y[:, 0] + k * (y[:, 1] - y[:, 0])
        toward = np.array([-np.inf, np.nan, np.inf], f32)[rng.integers(0, 3, (m, 2))]
        tx = np.where(np.isnan(toward[:, 0]), tx, np.nextafter(tx, toward[:, 0]))
        ty = np.where(np.isnan(toward[:, 1]), ty, np.nextafter(ty, toward[:, 1]))
        tris[g, :, :, 0] = np.stack([x[:, 0], x[:, 1], tx], 1)
        tris[g, :, :, 1] = np.stack([y[:, 0], y[:, 1], ty], 1)
        tris[g, :, :, 2:] = rng.choice([0.0, 1.0], (m, 3, 2)).astype(f32)
    classes = rng.integers(0, 4, (b, m)).astype(np.int32)
    return tris, classes, min_x, max_y, scale


def tile_keep(tris, classes, min_x, max_y, scale, *, height, width, offset=(0.0, 0.0)):
    """The kernel's cull (``csrc/loopblinn.cu``) for each 16 x 16 tile, with
    the plain version's edge functions: bool ``[B, M, tiles_y, tiles_x]``
    (``rect_keep``)."""
    return rect_keep(tris, classes, min_x, max_y, scale, height=height, width=width, rows=16,
                     cols=16, offset=offset)


def tile_inside(tris, min_x, max_y, scale, *, height, width, offset=(0.0, 0.0)):
    """Whether some pixel of each 16 x 16 tile is inside each triangle, as
    the plain version's ``inside`` says: bool ``[B, M, tiles_y, tiles_x]``."""
    px, py = winding_ref.sample_coords(min_x, max_y, scale, height=height, width=width,
                                       sample_offset=offset)
    inside = loopblinn_ref.inside_mask(*loopblinn_ref.edges(
        tris[:, :, None, None], px[:, None, None, :], py[:, None, :, None]))
    ty, tx = -(-height // 16), -(-width // 16)
    inside = torch.nn.functional.pad(inside, (0, tx * 16 - width, 0, ty * 16 - height))
    b, m = inside.shape[:2]
    return inside.reshape(b, m, ty, 16, tx, 16).any(dim=5).any(dim=3)


class TestCull:
    """The kernel's cull never drops a (triangle, tile) pair that has a
    pixel inside the triangle."""

    def assert_conservative(self, batch, h, w, offset=(0.0, 0.0)):
        args = tensors(*batch)
        keep = tile_keep(*args, height=h, width=w, offset=offset)
        needed = tile_inside(args[0], *args[2:], height=h, width=w, offset=offset)
        live = ((args[1] >= 0) & (args[1] <= 2))[..., None, None]
        assert not (needed & live & ~keep).any()
        return keep, needed & live

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("offset", [(0.0, 0.0), (1 / 3, 1 / 3)])
    def test_slivers(self, seed, offset):
        scale = [f32(1), f32(0.0625), f32(0.4), f32(3)][seed]
        batch = slivers(np.random.default_rng(seed), scale=scale, offset=offset)
        keep, needed = self.assert_conservative(batch, 80, 72, offset)
        # the slivers touch the tile edges: many pairs are needed, and the
        # cull drops most of the others
        assert needed.sum() > 1000 and keep.sum() < 2 * needed.sum()

    def test_ties(self):
        self.assert_conservative(tie_batch(), TIE_H, TIE_W)

    def test_config3_glyphs(self, config3):
        """Every 8th glyph of config 3's atlas: of the 306 triangles' 19,584
        (live triangle, tile) pairs the cull keeps 1,817, and 881 hold an
        inside pixel."""
        batch = tuple(a[::8] for a in config3[:4]) + (config3[4],)
        keep, needed = self.assert_conservative(batch, 128, 128)
        assert (int(keep.sum()), int(needed.sum())) == (1817, 881)


def rect_corners(min_x, max_y, scale, *, height, width, rows, cols, row0=0, offset=(0.0, 0.0)):
    """The sample rectangles of the ``rows x cols`` blocks of pixels that
    tile rows ``[row0, height)``: the px of each block's first and last
    column and the py of its first and last row, ``[B, n]`` each, as the
    kernel computes them (``pixel_x``, ``pixel_y``)."""
    px, py = winding_ref.sample_coords(min_x, max_y, scale, height=height, width=width,
                                       sample_offset=offset)
    c0, r0 = torch.arange(0, width, cols), torch.arange(row0, height, rows)
    c1, r1 = (c0 + cols).clamp(max=width) - 1, (r0 + rows).clamp(max=height) - 1
    return px[:, c0], px[:, c1], py[:, r0], py[:, r1]


def corner_tests(tris, min_x, max_y, scale, *, height, width, rows, cols, offset=(0.0, 0.0)):
    """Per triangle and block of pixels, per edge, whether ``e*sgn < 0`` and
    whether ``e*sgn >= 0`` at each of the four corners of the block's
    sample rectangle: two bool ``[4, 3, B, M, blocks_y, blocks_x]``."""
    x0, x1, y0, y1 = rect_corners(min_x, max_y, scale, height=height, width=width,
                                  rows=rows, cols=cols, offset=offset)
    tri = tris[:, :, None, None]  # [B, M, 1, 1, 3, 4]
    below, above = [], []
    for xs, ys in ((x0, y0), (x1, y0), (x0, y1), (x1, y1)):
        *e, area = loopblinn_ref.edges(tri, xs[:, None, None, :], ys[:, None, :, None])
        sgn = loopblinn_ref.sign(area)
        below.append(torch.stack([ek * sgn < 0 for ek in e]))
        above.append(torch.stack([ek * sgn >= 0 for ek in e]))
    return torch.stack(below), torch.stack(above), area


def rect_keep(tris, classes, min_x, max_y, scale, *, height, width, rows, cols,
              offset=(0.0, 0.0)):
    """The kernel's cull for blocks of ``rows x cols`` pixels: a band of the
    plan's rows across the width (``cols = width``), or a warp's 16 x 16
    tile. A triangle is kept unless it cannot draw, or for one edge ``e*sgn
    < 0`` at all four corners. bool ``[B, M, blocks_y, blocks_x]``."""
    below, _, area = corner_tests(tris, min_x, max_y, scale, height=height, width=width,
                                  rows=rows, cols=cols, offset=offset)
    misses = below.all(dim=0).any(dim=0)
    live = (classes >= 0) & (classes <= 2)
    return live[..., None, None] & ((area > 0) | (area < 0)) & ~misses


def tile_covered(tris, classes, min_x, max_y, scale, *, height, width, rows, cols,
                 offset=(0.0, 0.0)):
    """The kernel's covered tile: a live class-2 triangle with nonzero area
    whose three edges have ``e*sgn >= 0`` at all four corners of the ``rows
    x cols`` warp tile's sample rectangle. bool ``[B, M, tiles_y,
    tiles_x]``."""
    _, above, area = corner_tests(tris, min_x, max_y, scale, height=height, width=width,
                                  rows=rows, cols=cols, offset=offset)
    solid = (classes == loopblinn_ref.CLASS_SOLID)[..., None, None]
    return solid & ((area > 0) | (area < 0)) & above.all(dim=0).all(dim=0)


def needed_blocks(tris, min_x, max_y, scale, *, height, width, rows, cols, offset=(0.0, 0.0)):
    """The (triangle, block) pairs with a pixel inside the triangle, from
    ``loopblinn_ref.inside_pairs``: bool ``[B, M, blocks_y, blocks_x]``."""
    b, m = tris.shape[:2]
    need = torch.zeros((b, m, -(-height // rows), -(-width // cols)), dtype=torch.bool)
    for (bi, mi, yi, xi), *_ in loopblinn_ref.inside_pairs(
            tris, min_x, max_y, scale, height=height, width=width, sample_offset=offset):
        need[bi, mi, yi // rows, xi // cols] = True
    return need


# -- the launch plan: loopblinn.cu's make_plan, transcribed -------------------

LB_TILE, LB_WARP_ROWS, LB_CHUNK, LB_MAX_TILES, LB_MAX_COLS = 16, 8, 256, 32, 256
LB_FILL_BLOCKS_PER_SM = 2
H100_SMS = 132


def lb_plan(b, m, h, w, sms=H100_SMS):
    """(rows a band, row bands, columns a band, column bands, triangles a
    chunk, chunks) of the launch ``loopblinn()`` makes: up to 256 columns a
    block in whole 16-column tiles, and whole 8-row warp-tile rows up to 32
    warp tiles a block, fewer where the batch would give fewer than two
    blocks an SM. The card holds it to the C
    (``TestKernelOnCard.test_plan_matches_transcription``)."""
    col_bands = -(-w // LB_MAX_COLS)
    cols = -(-(-(-w // col_bands)) // LB_TILE) * LB_TILE
    tiles_x, tiles_y = cols // LB_TILE, -(-h // LB_WARP_ROWS)
    trows = min(max(LB_MAX_TILES // tiles_x, 1), tiles_y)
    units, fill = b * col_bands, LB_FILL_BLOCKS_PER_SM * sms
    if units * -(-tiles_y // trows) < fill:
        trows = min(trows, max(-(-tiles_y // -(-fill // units)), 1))
    trows = -(-tiles_y // -(-tiles_y // trows))
    rows = min(trows * LB_WARP_ROWS, h)
    return (rows, -(-h // rows), min(cols, w), -(-w // cols), LB_CHUNK,
            max(-(-m // LB_CHUNK), 1))


# (glyphs, triangles, height, width, plan): config 3's atlas, a shard of it
# (24 of its 96 padded glyphs), the CLI's one glyph, the CJK meshes beyond
# one chunk, a raster under one warp-tile row, wide rows in column bands, a
# narrow raster, and a batch large enough for whole 32-tile blocks
LB_PLANS = [
    (94, 126, 128, 128, (32, 4, 128, 1, 256, 1)),
    (24, 126, 128, 128, (16, 8, 128, 1, 256, 1)),
    (1, 80, 150, 110, (8, 19, 110, 1, 256, 1)),
    (32, 446, 64, 64, (8, 8, 64, 1, 256, 2)),
    (3, 4, 3, 12, (3, 1, 12, 1, 256, 1)),
    (300, 20, 80, 1000, (16, 5, 256, 4, 256, 1)),
    (300, 300, 80, 72, (40, 2, 72, 1, 256, 2)),
    (1000, 1, 64, 16, (64, 1, 16, 1, 256, 1)),
]


class TestLaunchPlan:
    @pytest.mark.parametrize("b,m,h,w,plan", LB_PLANS)
    def test_cases_take_their_plan(self, b, m, h, w, plan):
        assert lb_plan(b, m, h, w) == plan

    def test_blocks_cover_the_raster(self):
        """Bands of whole warp-tile rows and of whole tiles, each within the
        kernel's tables, that cover the raster."""
        for b in (1, 5, 94, 1000):
            for h in (1, 3, 4, 15, 16, 17, 80, 128, 300, 2049):
                for w in (1, 7, 16, 33, 72, 130, 256, 257, 512, 4000):
                    rows, row_bands, cols, col_bands, _, _ = lb_plan(b, 1, h, w)
                    assert (rows % LB_WARP_ROWS == 0 or rows == h) and 1 <= rows <= h
                    assert (cols % LB_TILE == 0 or cols == w) and 1 <= cols <= LB_MAX_COLS
                    assert (row_bands - 1) * rows < h <= row_bands * rows
                    assert (col_bands - 1) * cols < w <= col_bands * cols
                    warp_tiles = -(-rows // LB_WARP_ROWS) * -(-cols // LB_TILE)
                    assert rows <= LB_MAX_TILES * LB_WARP_ROWS
                    assert warp_tiles <= max(LB_MAX_TILES, -(-cols // LB_TILE))

    def test_small_batches_take_more_bands(self):
        """One glyph is cut into one-warp-tile-row bands, and a card with
        fewer SMs cuts a batch less."""
        assert lb_plan(1, 80, 128, 128)[:2] == (8, 16)
        assert lb_plan(94, 126, 128, 128, sms=1)[0] == 32


class TestBlockCull:
    """The band cull of the set-up and each warp's tile cull never drop a
    (triangle, block) pair with a pixel inside the triangle, as
    ``loopblinn_ref.inside_pairs`` finds them; and the covered tile is
    ink at every pixel."""

    BLOCKS = [(32, None), (8, None), (8, 16)]  # (rows, cols): blocks, and warp tiles

    def assert_conservative(self, batch, h, w, offset=(0.0, 0.0)):
        args = tensors(*batch)
        kept = {}
        for rows, cols in self.BLOCKS:
            cols = cols or w
            keep = rect_keep(*args, height=h, width=w, rows=rows, cols=cols, offset=offset)
            need = needed_blocks(args[0], *args[2:], height=h, width=w, rows=rows, cols=cols,
                                 offset=offset)
            live = ((args[1] >= 0) & (args[1] <= 2))[..., None, None]
            assert not (need & live & ~keep).any(), (rows, cols)
            kept[rows, cols] = (int(keep.sum()), int((need & live).sum()))
        return kept

    def assert_covered_tiles_are_ink(self, batch, h, w, offset=(0.0, 0.0)):
        """Every tile the test marks is ink at every pixel in the plain
        version, and inside the marking triangle at each."""
        args = tensors(*batch)
        th, tw = LB_WARP_ROWS, LB_TILE
        covered = tile_covered(*args, height=h, width=w, rows=th, cols=tw, offset=offset)
        out = loopblinn_ref.loopblinn_batch(*args, height=h, width=w, sample_offset=offset)
        px, py = winding_ref.sample_coords(*args[2:], height=h, width=w, sample_offset=offset)
        for bi, mi, ty, tx in covered.nonzero().tolist():
            rs, cs = slice(th * ty, th * ty + th), slice(tw * tx, tw * tx + tw)
            assert out[bi, rs, cs].all(), (bi, mi, ty, tx)
            e = loopblinn_ref.edges(args[0][bi, mi], px[bi, cs][None, :], py[bi, rs][:, None])
            assert loopblinn_ref.inside_mask(*e).all()
        return int(covered.sum())

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("offset", [(0.0, 0.0), (1 / 3, 1 / 3)])
    def test_slivers(self, seed, offset, one_torch_thread):
        scale = [f32(1), f32(0.0625), f32(0.4), f32(3)][seed]
        batch = slivers(np.random.default_rng(seed), scale=scale, offset=offset)
        kept = self.assert_conservative(batch, 80, 72, offset)
        assert kept[8, 16][1] > 1000 and kept[8, 16][0] < 2 * kept[8, 16][1]
        self.assert_covered_tiles_are_ink(batch, 80, 72, offset)

    def test_ties(self, one_torch_thread):
        self.assert_conservative(tie_batch(), TIE_H, TIE_W)
        # the solid triangles' tile holds pixels outside them: not covered
        assert self.assert_covered_tiles_are_ink(tie_batch(), TIE_H, TIE_W) == 0

    def test_config3_glyphs(self, config3, one_torch_thread):
        """Every 8th glyph of config 3's atlas, 306 live triangles: its
        32-row blocks keep 848 of their 1,224 (triangle, block) pairs,
        8-row blocks would keep 2,923 of 4,896, and the 16 x 8 warp tiles
        2,646 of 39,168, 1,292 of them with a pixel inside. At 128 px no tile
        lies inside one solid triangle: the strokes are thinner than a
        tile."""
        batch = tuple(a[::8] for a in config3[:4]) + (config3[4],)
        kept = self.assert_conservative(batch, 128, 128)
        assert (kept[32, 128][0], kept[8, 128][0], kept[8, 16]) == (848, 2923, (2646, 1292))
        assert self.assert_covered_tiles_are_ink(batch, 128, 128) == 0

    def test_covered_tiles_at_512_px(self, dejavu, one_torch_thread):
        """'I' and '.' at 512 px: tiles inside one solid triangle, each ink."""
        batch = mesh_batch(dejavu, "I.", 512, 512)
        assert self.assert_covered_tiles_are_ink(batch, 512, 512) > 0

    def test_covered_tile_of_a_large_triangle(self, one_torch_thread):
        """A solid triangle over the whole raster covers every tile, and one
        that misses a tile's corner by a float32 step covers none there."""
        scale = f32(0.5)
        big = [(-1000.0, -1000.0, 0, 0), (1000.0, -1000.0, 0, 0), (0.0, 1000.0, 0, 0)]
        tris = np.array([[big]], f32)
        batch = (tris, np.array([[2]], np.int32), np.zeros(1, np.int32),
                 np.full(1, 40, np.int32), scale)
        assert self.assert_covered_tiles_are_ink(batch, 48, 48) == 18
        # an edge through the sample column of the first tile's last pixel
        x = np.nextafter(f32(15 / scale), f32(np.inf))
        tris2 = np.array([[[(x, -1000.0, 0, 0), (1000.0, -1000.0, 0, 0), (x, 1000.0, 0, 0)]]],
                         f32)
        batch2 = (tris2, *batch[1:])
        assert self.assert_covered_tiles_are_ink(batch2, 48, 48) == 12


# --- on the card -------------------------------------------------------------

def assert_card_equals_ref(batch, h, w, device, offset=(0.0, 0.0)):
    args = tensors(*batch, device=device)
    before = loopblinn.launches
    out = loopblinn.loopblinn_batch(*args, height=h, width=w, sample_offset=offset)
    torch.cuda.synchronize()
    assert loopblinn.launches == before + (1 if out.numel() else 0)
    want = loopblinn_ref.loopblinn_batch(*args, height=h, width=w, sample_offset=offset)
    assert out.dtype == torch.bool and out.shape == want.shape
    assert int((out != want).sum()) == 0
    return out


@pytest.mark.requires_cuda
class TestKernelOnCard:
    def test_config3_atlas(self, cuda, config3):
        out = assert_card_equals_ref(config3, 128, 128, cuda)
        np.testing.assert_array_equal(out.cpu().numpy(), port_ref(config3, 128, 128))

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("offset", [(0.0, 0.0), (1 / 3, 1 / 3)])
    def test_slivers_next_to_tile_edges(self, cuda, seed, offset):
        rng = np.random.default_rng(seed)
        scale = [f32(1), f32(0.0625), f32(0.4), f32(3)][seed]
        out = assert_card_equals_ref(slivers(rng, scale=scale, offset=offset), 80, 72, cuda,
                                     offset)
        assert out.any()

    def test_cjk_meshes(self, cuda):
        """32 CJK meshes of up to 446 triangles at 64 px: more than one
        shared-memory chunk of triangles."""
        logging.getLogger("fontrx_torch.geometry").setLevel(logging.ERROR)
        batch = mesh_batch(Font.open(CJK), CJK_CHARS, 64, 64)
        assert batch[0].shape[1] == 446
        assert_card_equals_ref(batch, 64, 64, cuda)

    def test_ties(self, cuda):
        out = assert_card_equals_ref(tie_batch(), TIE_H, TIE_W, cuda)
        np.testing.assert_array_equal(out.cpu().numpy(), tie_expected())

    def test_nan(self, cuda):
        tris, classes, min_x, max_y, scale = tie_batch()
        tris[:2, 0, 1, 0] = np.nan
        tris[2, 0, 0, 2] = np.nan  # a NaN texcoord
        out = assert_card_equals_ref((tris, classes, min_x, max_y, scale), TIE_H, TIE_W, cuda)
        assert not out[:2].any()

    @pytest.mark.parametrize("h,w", [(1, 1), (17, 33), (130, 7)])
    def test_ragged_sizes(self, cuda, dejavu, h, w):
        assert_card_equals_ref(mesh_batch(dejavu, "AQg", 64, 64), h, w, cuda)

    @pytest.mark.parametrize("b,m,h,w", [(0, 4, 5, 7), (2, 0, 5, 7), (2, 4, 0, 7)])
    def test_empty(self, cuda, b, m, h, w):
        batch = (np.zeros((b, m, 3, 4), f32), np.full((b, m), 3, np.int32),
                 np.zeros(b, np.int32), np.zeros(b, np.int32), f32(1))
        out = assert_card_equals_ref(batch, h, w, cuda)
        assert tuple(out.shape) == (b, h, w) and not out.any()

    def test_fill_on_card(self, cuda, dejavu):
        glyph = dejavu.get_glyph("g")[0]
        mesh = TriangulatedGlyph.from_glyph(glyph)
        grid = RasterGrid.for_glyph_box(box_of(glyph), 128, dejavu.info.units_per_em)
        before = loopblinn.launches
        out = loopblinn.loopblinn_fill(mesh, grid)
        assert loopblinn.launches == before + 1
        np.testing.assert_array_equal(out, loopblinn.loopblinn_fill(mesh, grid, device="cpu"))

    def test_wrapper_rejects_bad_inputs(self, cuda):
        tris = torch.zeros((2, 4, 3, 4), device=cuda)
        cls = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
        anchors = torch.zeros(2, dtype=torch.int32, device=cuda)
        before = loopblinn.launches
        with pytest.raises(TypeError):
            loopblinn.loopblinn_batch(tris.double(), cls, anchors, anchors, 1.0, height=8,
                                      width=8)
        with pytest.raises(TypeError):
            loopblinn.loopblinn_batch(tris, cls.float(), anchors, anchors, 1.0, height=8,
                                      width=8)
        with pytest.raises(ValueError):
            loopblinn.loopblinn_batch(tris, cls[:, :2], anchors, anchors, 1.0, height=8,
                                      width=8)
        with pytest.raises(ValueError):
            loopblinn.loopblinn_batch(tris[:, :, :2], cls, anchors, anchors, 1.0, height=8,
                                      width=8)
        with pytest.raises(ValueError):
            loopblinn.loopblinn_batch(tris, cls, anchors, anchors, 0.0, height=8, width=8)
        with pytest.raises(ValueError):
            loopblinn.loopblinn_batch(tris, cls.cpu(), anchors, anchors, 1.0, height=8,
                                      width=8)
        assert loopblinn.launches == before

    def test_failed_launch_raises(self, cuda, monkeypatch):
        """The kernel's entry refuses a negative triangle count; the wrapper
        raises and counts no launch."""
        lib = _build.load("loopblinn")

        class BadCount:
            @staticmethod
            def loopblinn(*args):
                args = list(args)
                args[8] = -1  # M
                return lib.loopblinn(*args)

        monkeypatch.setattr(_build, "load", lambda name: BadCount)
        tris = torch.zeros((1, 4, 3, 4), device=cuda)
        cls = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
        anchors = torch.zeros(1, dtype=torch.int32, device=cuda)
        before = loopblinn.launches
        with pytest.raises(RuntimeError, match="loopblinn kernel launch failed"):
            loopblinn.loopblinn_batch(tris, cls, anchors, anchors, 1.0, height=8, width=8)
        assert loopblinn.launches == before

    def test_plan_matches_transcription(self, cuda):
        card = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert loopblinn.plan(8, 64, 64, 64) == loopblinn.plan(8, 64, 64, 64, sms=card)
        for sms in (card, 1, 66, H100_SMS):
            for b in (1, 3, 24, 94, 1000):
                for m in (0, 1, 126, 256, 257, 446):
                    for h in (1, 12, 16, 17, 64, 80, 128, 300):
                        for w in (1, 7, 33, 72, 128, 130, 1000):
                            assert (loopblinn.plan(b, m, h, w, sms=sms)
                                    == lb_plan(b, m, h, w, sms=sms)), (b, m, h, w, sms)

    @pytest.mark.parametrize("b,m,h,w,want", LB_PLANS)
    def test_every_plan(self, cuda, dejavu, b, m, h, w, want):
        """Each labelled plan on glyph meshes padded to ``m`` triangles (the
        CJK meshes where ``m`` is 446) and tiled to ``b`` glyphs, with rows
        through the glyphs' middle, at two sample offsets."""
        if m == 446:
            logging.getLogger("fontrx_torch.geometry").setLevel(logging.ERROR)
            batch = mesh_batch(Font.open(CJK), CJK_CHARS, 64, 64)
        else:
            batch = mesh_batch(dejavu, "AQg@&%Wb"[: max(1, min(8, b))], 64, 64)
        tris, classes = batch[:2]
        m_have = tris.shape[1]
        if m_have > m:  # keep each mesh's first m triangles
            tris, classes = tris[:, :m], classes[:, :m]
        elif m_have < m:
            tris = np.concatenate([tris, np.zeros((len(tris), m - m_have, 3, 4), f32)], 1)
            classes = np.concatenate([classes, np.full((len(tris), m - m_have), 3, np.int32)], 1)
        reps = -(-b // len(tris))
        tris, classes, min_x, max_y = (np.concatenate([a] * reps)[:b] for a in
                                       (tris, classes, batch[2], batch[3]))
        args = (tris, classes, min_x - w // 2 + 32, max_y - 32 + h // 2, batch[4])
        assert loopblinn.plan(b, m, h, w) == lb_plan(b, m, h, w, sms=plan_sms(cuda))
        if plan_sms(cuda) == H100_SMS:
            assert loopblinn.plan(b, m, h, w) == want
        for offset in [(0.0, 0.0), (0.25, -1 / 3)]:
            out = assert_card_equals_ref(args, h, w, cuda, offset)
            assert out.any() or m < 20  # a few triangles may miss the raster

    @pytest.mark.parametrize("h,w", [(16, 130), (33, 72), (7, 1), (130, 33)])
    def test_ragged_widths(self, cuda, dejavu, h, w):
        """Rows whose lanes store 8, 4 or 1 bytes, and tiles cut by the
        raster's edges."""
        batch = mesh_batch(dejavu, "AQg", 64, 64)
        args = (*batch[:2], batch[2] - w // 2 + 32, batch[3] - 32 + h // 2, batch[4])
        assert_card_equals_ref(args, h, w, cuda)


def plan_sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count
