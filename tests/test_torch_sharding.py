"""fontrx_torch's multi-device path (``engine/sharding.py`` and the dry runs in
``entry.py``) against the JAX package's, on the CPU.

- K4 (``winding_pallas_batch``, run in interpret mode) equals the port's
  winding (``winding.winding_batch``, whose CPU route is the plain version)
  and the oracle (``contract=False``) bit for bit, at three sample offsets.
- Each sharded family of the port, on a CPU mesh of 8 shards (1-D), of 4 x
  2 (glyphs x rows) and on a row mesh of 8, equals the JAX function of the
  same name on the conftest's 8-device CPU mesh: with ``use_pallas=True,
  interpret=True`` for the winding families (as ``tests/test_kernels.py``
  runs them) and for the SDF (whose jnp fallback is another program), else
  ``use_pallas=False``. Bit for bit, but the SDF within ``TOL`` (1e-4 px,
  ``tests/test_torch_sdf.py``'s bound: XLA:CPU fuses the Newton program).
- Sharded equals unsharded in the port at mesh sizes 1, 2 and 8; a batch
  that does not divide raises; a mesh with no card raises.
- ``dryrun_multichip(n, device="cpu")`` passes, and
  ``dryrun_multihost(2, 4, device="cpu")`` (two gloo ranks on localhost)
  gathers the map that JAX's ``winding_sharded`` computes.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fontrx.engine import sharding as jax_sharding
from fontrx.kernels import oracle
from fontrx.kernels.winding_pallas import winding_pallas_batch
from fontrx_torch import entry
from fontrx_torch.engine import sharding
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.font.font import Font
from fontrx_torch.geometry import TriangulatedGlyph
from fontrx_torch.kernels import (
    coverage_ref, loopblinn, page_ref, sdf_ref, winding, winding_ref)
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.scene.layout import layout_text
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEJAVU = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
CHARS = "ABCDEFGH"
TILE = 64
TOL = 1e-4
OFFSETS = [(0.0, 0.0), (0.25, 0.25), (-0.25, -0.25)]  # two of the 2 x 2 MSAA lattice's
f32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The inputs are small, so torch runs on one thread here. With one per
    core, parallel test workers spin against each other: four copies of this
    module at once on an 8-core CPU took 286 s, and 33 s with one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n):
    return sharding.make_mesh(devices=["cpu"] * n)


def tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def np_gather(mesh, shards):
    return sharding.gather(mesh, shards).numpy()


@pytest.fixture(scope="module")
def font():
    return Font.open(DEJAVU)


def glyph_batch(font, size):
    """The 8 glyphs of ``CHARS`` on ``size`` x ``size`` tiles at ``size`` px,
    as NumPy."""
    batch = pack_charset(font, CHARS)
    grids = [RasterGrid.fixed_tile(tuple(b), size, font.info.units_per_em, size)
             for b in batch.boxes]
    return (batch.segments, np.array([g.min_x for g in grids], np.int32),
            np.array([g.max_y for g in grids], np.int32), f32(grids[0].scale))


@pytest.fixture(scope="module")
def glyphs(font):
    return glyph_batch(font, TILE)


@pytest.fixture(scope="module")
def glyphs32(font):
    """The SDF's size, as in the JAX package's sharded SDF test."""
    return glyph_batch(font, 32)


@pytest.fixture(scope="module")
def meshes(font):
    """``CHARS`` triangulated by the port, padded to one triangle count."""
    tris, classes = loopblinn.pack_meshes(
        [TriangulatedGlyph.from_glyph(font.get_glyph(c)[0]) for c in CHARS])
    return tris, classes


@pytest.fixture(scope="module")
def page_segments(font):
    """Two lines on a 256 x 64 page at the first view (its transform is
    exact, so no root strays), as page-pixel segments ``[1, S, 3, 2]``."""
    w, h = 256, 64
    renderer = PageRenderer(font, layout_text(font, "ab\ncd"), w, h, "cpu")
    inputs = renderer.page_inputs(ViewTransform.init(font.info.units_per_em, w, h))
    return page_ref.transform_segments(*inputs)[None].numpy(), h, w


def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8-device CPU mesh")
    return jax_sharding.make_mesh()


def jax_args(segments, min_x, max_y):
    return jnp.asarray(segments), jnp.asarray(min_x), jnp.asarray(max_y)


# --- K4 -----------------------------------------------------------------------


def k4_inputs(height, width):
    """The example batch's diamonds with anchors drawn from a seed so that
    the ``height`` rows cross them, and four DejaVu glyphs at 96 px."""
    rng = np.random.default_rng(14)
    segs, _, _, scale = entry._example_batch(b=8, s=8, tile=width)
    min_x = rng.integers(-24, 8, 8).astype(np.int32)
    max_y = rng.integers(height, 110, 8).astype(np.int32)
    return segs, min_x, max_y, scale


@pytest.fixture(scope="module")
def k4_glyphs(font):
    batch = pack_charset(font, "Qg@&")
    return batch.segments, np.full(4, -4, np.int32), np.full(4, 60, np.int32), f32(96 / 2048)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("height,width", [(8, 128), (16, 256)])
def test_k4_interpret_equals_port(k4_glyphs, height, width, offset):
    for segs, min_x, max_y, scale in (k4_inputs(height, width), k4_glyphs):
        k4 = np.asarray(winding_pallas_batch(
            *jax_args(segs, min_x, max_y), jnp.float32(scale), height=height, width=width,
            interpret=True, sample_offset=offset))
        port = winding.winding_batch(*tensors(segs, min_x, max_y), float(scale),
                                     height=height, width=width, sample_offset=offset).numpy()
        assert (port != 0).any()
        np.testing.assert_array_equal(port, k4)
        ox, oy = (f32(v) for v in offset)
        for i in range(len(segs)):
            xs = ((min_x[i] + np.arange(width)).astype(f32) + ox) / f32(scale)
            ys = ((max_y[i] - np.arange(height)).astype(f32) + oy) / f32(scale)
            np.testing.assert_array_equal(
                port[i], oracle.winding_at(segs[i], xs[None, :], ys[:, None], contract=False))


# --- each family against the JAX package ------------------------------------


@pytest.fixture(scope="module")
def jax_winding(glyphs):
    """JAX ``winding_sharded`` (K4 in interpret mode) on the 8-device mesh."""
    segs, min_x, max_y, scale = glyphs
    seg, mx, my = jax_sharding.shard_batch(jax_mesh(), *jax_args(segs, min_x, max_y))
    return np.asarray(jax_sharding.winding_sharded(
        seg, mx, my, jnp.float32(scale), height=TILE, width=128, mesh=jax_mesh(),
        use_pallas=True, interpret=True))


def test_winding_sharded_vs_jax(glyphs, jax_winding):
    segs, min_x, max_y, scale = glyphs
    mesh = cpu_mesh(8)
    shards = sharding.winding_sharded(*tensors(segs, min_x, max_y), float(scale), height=TILE,
                                      width=128, mesh=mesh)
    assert len(shards) == 8 and all(s.shape == (1, TILE, 128) for s in shards)
    np.testing.assert_array_equal(np_gather(mesh, shards), jax_winding)


@pytest.mark.parametrize("height", [128, 256])  # bands of 64 rows (K4's route), 128 (K1's)
def test_winding_sharded_2d_vs_jax(glyphs, height):
    segs, min_x, max_y, scale = glyphs
    jax_mesh()
    want = np.asarray(jax_sharding.winding_sharded_2d(
        *jax_args(segs, min_x, max_y), jnp.float32(scale), height=height, width=128,
        mesh=jax_sharding.make_mesh_2d(4, 2), use_pallas=True, interpret=True))
    mesh = sharding.make_mesh_2d(4, 2, ["cpu"] * 8)
    shards = sharding.winding_sharded_2d(*tensors(segs, min_x, max_y), float(scale),
                                         height=height, width=128, mesh=mesh)
    assert all(s.shape == (2, height // 2, 128) for s in shards)
    got = np_gather(mesh, shards)
    assert (got != 0).any()
    np.testing.assert_array_equal(got, want)


def test_coverage_sharded_vs_jax(glyphs):
    segs, min_x, max_y, scale = glyphs
    mesh = jax_mesh()
    seg, mx, my = jax_sharding.shard_batch(mesh, *jax_args(segs, min_x, max_y))
    want = np.asarray(jax_sharding.coverage_sharded(
        seg, mx, my, jnp.float32(scale), height=TILE, width=TILE, samples=2, mesh=mesh,
        use_pallas=False))
    got = np_gather(cpu_mesh(8), sharding.coverage_sharded(
        *tensors(segs, min_x, max_y), float(scale), height=TILE, width=TILE, samples=2,
        mesh=cpu_mesh(8)))
    assert ((got > 0) & (got < 1)).any()
    np.testing.assert_array_equal(got, want)


def test_sdf_sharded_vs_jax(glyphs32):
    segs, min_x, max_y, scale = glyphs32
    mesh = jax_mesh()
    seg, mx, my = jax_sharding.shard_batch(mesh, *jax_args(segs, min_x, max_y))
    want = np.asarray(jax_sharding.sdf_sharded(
        seg, mx, my, jnp.float32(scale), height=32, width=32, mesh=mesh, use_pallas=True,
        interpret=True, flat=True))
    got = np_gather(cpu_mesh(8), sharding.sdf_sharded(
        *tensors(segs, min_x, max_y), float(scale), height=32, width=32, mesh=cpu_mesh(8)))
    assert (np.abs(got) < sdf_ref.SPREAD_PX).any()
    assert np.abs(got - want).max() < TOL


def test_loopblinn_sharded_vs_jax(glyphs, meshes):
    _, min_x, max_y, scale = glyphs
    tris, classes = meshes
    want = np.asarray(jax_sharding.loopblinn_sharded(
        jnp.asarray(tris), jnp.asarray(classes), jnp.asarray(min_x), jnp.asarray(max_y),
        jnp.float32(scale), height=TILE, width=TILE, mesh=jax_mesh(), use_pallas=False))
    got = np_gather(cpu_mesh(8), sharding.loopblinn_sharded(
        *tensors(tris, classes, min_x, max_y), float(scale), height=TILE, width=TILE,
        mesh=cpu_mesh(8)))
    assert got.any()
    np.testing.assert_array_equal(got, want)


def test_dense_sharded_vs_jax(glyphs):
    """The reference's dense leg (K2's map at its 128-row tile) is the port's
    ``winding_sharded`` at ``height=128``."""
    segs, min_x, max_y, scale = glyphs
    mesh = jax_mesh()
    seg, mx, my = jax_sharding.shard_batch(mesh, *jax_args(segs, min_x, max_y))
    want = np.asarray(jax_sharding.dense_sharded(
        seg, mx, my, jnp.float32(scale), height=128, width=128, mesh=mesh, use_pallas=False))
    got = np_gather(cpu_mesh(8), sharding.winding_sharded(
        *tensors(segs, min_x, max_y), float(scale), height=128, width=128, mesh=cpu_mesh(8)))
    np.testing.assert_array_equal(got, want)


def test_page_rows_sharded_vs_jax(page_segments):
    flat, h, w = page_segments
    jax_mesh()
    want = np.asarray(jax_sharding.page_rows_sharded(
        jnp.asarray(flat), h, w, mesh=jax_sharding.make_row_mesh(), use_pallas=False))
    mesh = sharding.make_row_mesh(devices=["cpu"] * 8)
    shards = sharding.page_rows_sharded(torch.from_numpy(flat), h, w, mesh=mesh)
    assert all(s.shape == (128, w) for s in shards)  # 64 rows padded to 8 x 128
    got = np_gather(mesh, shards)
    assert got[:h].any()
    np.testing.assert_array_equal(got, want)


# --- sharded equals unsharded in the port -------------------------------------


@pytest.mark.parametrize("n", [1, 2, 8])
class TestShardedEqualsUnsharded:
    def test_winding(self, glyphs, n):
        segs, min_x, max_y, scale = glyphs
        args = (*tensors(segs, min_x, max_y), float(scale))
        got = sharding.gather(cpu_mesh(n), sharding.winding_sharded(
            *args, height=TILE, width=TILE, mesh=cpu_mesh(n)))
        assert torch.equal(got, winding_ref.winding_batch(*args, height=TILE, width=TILE))

    def test_winding_2d(self, glyphs, n):
        segs, min_x, max_y, scale = glyphs
        args = (*tensors(segs, min_x, max_y), float(scale))
        n_glyph = max(n // 2, 1)
        mesh = sharding.make_mesh_2d(n_glyph, n // n_glyph, ["cpu"] * n)
        got = sharding.gather(mesh, sharding.winding_sharded_2d(*args, height=TILE, width=TILE,
                                                                mesh=mesh))
        assert torch.equal(got, winding_ref.winding_batch(*args, height=TILE, width=TILE))

    def test_coverage(self, glyphs, n):
        segs, min_x, max_y, scale = glyphs
        args = (*tensors(segs, min_x, max_y), float(scale))
        got = sharding.gather(cpu_mesh(n), sharding.coverage_sharded(
            *args, height=TILE, width=TILE, mesh=cpu_mesh(n)))
        assert torch.equal(got, coverage_ref.coverage_batch(*args, height=TILE, width=TILE,
                                                            samples=2))

    def test_sdf(self, glyphs32, n):
        segs, min_x, max_y, scale = glyphs32
        args = (*tensors(segs, min_x, max_y), float(scale))
        got = sharding.gather(cpu_mesh(n), sharding.sdf_sharded(
            *args, height=32, width=32, mesh=cpu_mesh(n)))
        want = sdf_ref.sdf_batch(*args, height=32, width=32)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    def test_loopblinn(self, glyphs, meshes, n):
        _, min_x, max_y, scale = glyphs
        args = (*tensors(*meshes, min_x, max_y), float(scale))
        got = sharding.gather(cpu_mesh(n), sharding.loopblinn_sharded(
            *args, height=TILE, width=TILE, mesh=cpu_mesh(n)))
        assert torch.equal(got, loopblinn.loopblinn_batch(*args, height=TILE, width=TILE))

    def test_page_rows(self, page_segments, n):
        flat, h, w = page_segments
        mesh = sharding.make_row_mesh(devices=["cpu"] * n)
        got = sharding.gather(mesh, sharding.page_rows_sharded(torch.from_numpy(flat), h, w,
                                                               mesh=mesh))
        assert got.shape == (128 * n, w)
        q = torch.from_numpy(flat[0])
        want = page_ref.direct_page(q, torch.zeros(len(q), dtype=torch.int32),
                                    torch.zeros((1, 2)), 1.0, page_h=h, page_w=w,
                                    out_h=128 * n, mode="winding")
        assert torch.equal(got, want)


# --- the mesh -------------------------------------------------------------------


def test_batch_that_does_not_divide_raises(glyphs):
    segs, min_x, max_y, scale = glyphs
    with pytest.raises(ValueError, match="does not divide"):
        sharding.winding_sharded(*tensors(segs[:7], min_x[:7], max_y[:7]), float(scale),
                                 height=8, width=8, mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="does not divide"):
        sharding.winding_sharded_2d(*tensors(segs, min_x, max_y), float(scale), height=9,
                                    width=8, mesh=sharding.make_mesh_2d(2, 2, ["cpu"] * 4))


def test_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (sharding.make_mesh, sharding.make_row_mesh, lambda: sharding.make_mesh_2d(1, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multihost(2, 1)


@pytest.mark.parametrize("cards,want", [(1, [0] * 8), (3, [0, 1, 2, 0, 1, 2, 0, 1])])
def test_mesh_places_shards_round_robin(monkeypatch, cards, want):
    """More shards than cards: round robin over the cards (no card is
    touched, only named)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    mesh = sharding.make_mesh(8)
    assert [d.index for d in mesh.flat()] == want and mesh.axis_names == ("glyphs",)
    assert len(sharding.make_mesh().flat()) == cards
    mesh2 = sharding.make_mesh_2d(4, 2)
    assert mesh2.axis_names == ("glyphs", "rows") and mesh2.devices.shape == (4, 2)
    assert mesh2.devices[1, 0].index == want[2]


def test_winding_shards_are_what_the_families_run(glyphs):
    """``winding_shards`` is the split both winding families run: shard
    ``(g, r)`` holds glyph shard ``g`` with its anchors dropped by ``r``
    bands, on its device, and its map is that shard's part of the whole."""
    segs, min_x, max_y, scale = glyphs
    args = tensors(segs, min_x, max_y)
    mesh = sharding.make_mesh_2d(4, 2, ["cpu"] * 8)
    shards = sharding.winding_shards(*args, height=TILE, mesh=mesh)
    assert [(s.glyphs, s.row0, s.rows) for s in shards] == [
        (slice(2 * g, 2 * g + 2), r * TILE // 2, TILE // 2) for g in range(4) for r in range(2)]
    for s in shards:
        assert torch.equal(s.segments, args[0][s.glyphs])
        assert torch.equal(s.max_y, args[2][s.glyphs] - s.row0)
    whole = winding_ref.winding_batch(*args, float(scale), height=TILE, width=TILE)
    maps = sharding.winding_sharded_2d(*args, float(scale), height=TILE, width=TILE, mesh=mesh)
    for s, got in zip(shards, maps):
        assert torch.equal(got, whole[s.glyphs, s.row0 : s.row0 + s.rows])
    one_d = sharding.winding_shards(*args, height=TILE, mesh=cpu_mesh(8))
    assert [(s.glyphs, s.row0, s.rows) for s in one_d] == [
        (slice(g, g + 1), 0, TILE) for g in range(8)]


def test_family_refuses_a_mesh_of_other_axes(glyphs, page_segments):
    segs, min_x, max_y, scale = glyphs
    args = (*tensors(segs, min_x, max_y), float(scale))
    rows = sharding.make_row_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="axes"):
        sharding.winding_sharded(*args, height=8, width=8, mesh=rows)
    with pytest.raises(ValueError, match="axes"):
        sharding.winding_sharded_2d(*args, height=8, width=8, mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="axes"):
        sharding.coverage_sharded(*args, height=8, width=8, mesh=rows)
    flat, h, w = page_segments
    with pytest.raises(ValueError, match="axes"):
        sharding.page_rows_sharded(torch.from_numpy(flat), h, w, mesh=cpu_mesh(2))


def test_mesh_takes_explicit_devices():
    mesh = sharding.make_mesh(2, ["cpu"] * 4)
    assert mesh.size == 2 and all(d.type == "cpu" for d in mesh.flat())
    with pytest.raises(ValueError, match="needs 4 devices"):
        sharding.make_mesh(4, ["cpu"] * 2)


# --- the dry runs -----------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 8])  # 3: no 2-D leg, as in the reference
def test_dryrun_multichip_cpu(n):
    entry.dryrun_multichip(n, device="cpu")


def test_dryrun_multichip_catches_a_shard_out_of_order(monkeypatch):
    """Every leg has ink and is held to its one-shard result, so shards
    gathered in the wrong order fail the dry run."""
    gather = sharding.gather
    monkeypatch.setattr(sharding, "gather",
                        lambda mesh, shards, device=None: gather(mesh, shards[::-1], device))
    with pytest.raises(RuntimeError, match="sharded winding: the gathered shards differ"):
        entry.dryrun_multichip(2, device="cpu")


def test_dryrun_multihost_cpu():
    gathered, launches = entry.dryrun_multihost(2, 4, device="cpu")
    assert launches == [0, 0]  # the plain version on the CPU
    segs, min_x, max_y, scale = entry.multihost_batch(16)
    mesh = jax_mesh()
    seg, mx, my = jax_sharding.shard_batch(mesh, *jax_args(segs, min_x, max_y))
    want = np.asarray(jax_sharding.winding_sharded(
        seg, mx, my, jnp.float32(scale), height=8, width=128, mesh=mesh, use_pallas=False))
    assert gathered.shape == (16, 8, 128) and (gathered != 0).any()
    np.testing.assert_array_equal(gathered, want)
