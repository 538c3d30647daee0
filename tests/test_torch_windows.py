"""fontrx_torch's window-packed atlas path (K3's function) against the JAX
package's, on the CPU, and its CUDA kernel against the plain version on the
card.

- ``pack.windows.pack_windows`` equals ``pack_dense_windows`` window by
  window: the same live copies in the same order, zeros after them.
- ``winding_ref.winding_windows_batch`` equals ``winding_dense_win_batch(
  exact=True, interpret=True)`` bit for bit, and the engine's
  ``pack_windows`` + ``winding_batch(windows=)`` equals the JAX engine's in
  interpret mode. On these glyphs it also equals the oracle
  (``contract=False``) and the unwindowed winding.
- A near-line whose rounded roots stray onto rows outside its windows: the
  port drops them, as K3 does, and the unwindowed winding counts them. K3
  runs there in a second JAX process whose XLA:CPU emits no fused
  multiply-add, and the port equals it bit for bit.

The module imports JAX only inside the tests that compare with it, so the
card's tests also run where there is no JAX:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_windows.py``.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks import cjk as ref_cjk
from fontrx.kernels import oracle
from fontrx_torch.bench import cjk
from fontrx_torch.convert import grid_anchors
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import _build, winding, winding_ref
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.windows import pack_windows, win_rows_for
from tests import test_torch_winding as wt

ROOT = pathlib.Path(__file__).resolve().parents[1]
CJK = ROOT / "tests" / "data" / "cjktest.ttf"
CJK_CHARS = [0x4E00 + i for i in (0, 37, 211, 502, 777, 1023)]
OFFSETS = [(0.25, 0.75), (-0.5, 0.5), (0.0, -1.0)]
# (height, width): the three row heights of the windows (32, 16 and 128
# rows), a last window cut by the height, and a width below the reference's
# padding to 8 columns
SHAPES = [(64, 64), (32, 32), (128, 128), (48, 48), (64, 60)]

f32 = np.float32
T = torch.from_numpy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def synthetic(n=3, seed=11):
    """``n`` glyphs of 280 ``synthetic_strokes`` segments."""
    rng = np.random.default_rng(seed)
    return np.stack([cjk.synthetic_strokes(rng, 280) for _ in range(n)])


def anchors(n, height):
    """The CJK benchmark's anchors: ``min_x = 0``, ``max_y = height - 1``."""
    return np.zeros(n, np.int32), np.full(n, height - 1, np.int32)


def near_line(y=1200.0, d=2.0**-13):
    """A closed glyph of a nearly straight quadratic from (100, y) to
    (1900, y), its control point ``d`` font units above, and the flat line
    back. At 64 px its hull lies between rows 25 and 26, but its float
    program finds a double root at t = 0.5 (winding 2 left of x = 1000) on
    every row from 23 to 39, where ``fl(cy*a + p1y*p1y) == fl(p0y*p2y)``.
    The pack puts it in window 0 (rows 0-31) alone, so K3 drops rows 32-39."""
    return np.array([[[100, y], [1000, y + d], [1900, y]],
                     [[1900, y], [1000, y], [100, y]]], f32)


def stray_batch():
    """Two synthetic glyphs and the near-line, with the anchors and scale
    of 64 px."""
    line = np.zeros((1, 280, 3, 2), f32)
    line[0, :2] = near_line()
    return np.concatenate([synthetic(2), line]), *anchors(3, 64), f32(64 / cjk.UPEM)


# K3 in interpret mode on ``stray_batch()``, in a JAX process whose XLA:CPU
# generates code for AVX at most, which has no fused multiply-add. The CPU
# backend fixes its target when it starts, so this takes a process of its
# own.
INTERPRET_WITHOUT_FMA = """
import sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
sys.path[:0] = ["tests", "."]
from test_torch_windows import jax_k3, stray_batch
np.save(sys.argv[1], jax_k3(*stray_batch(), 64, 64))
"""


@pytest.fixture(scope="module", autouse=True)
def interpret_without_fma(tmp_path_factory):
    """Starts the run of ``INTERPRET_WITHOUT_FMA`` when the module starts,
    so that its compiles overlap the other tests; yields a function that
    waits for it and returns K3's map."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    out = tmp_path_factory.mktemp("interpret") / "k3.npy"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.Popen([sys.executable, "-c", INTERPRET_WITHOUT_FMA, str(out)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)

    def result():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log.decode()[-4000:]
        return np.load(out)

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def cjk_glyphs():
    """Six glyphs of ``tests/data/cjktest.ttf`` (200-330 segments)."""
    font = Font.open(CJK)
    return pack_charset(font, CJK_CHARS), font.info.units_per_em


def cjk_inputs(cjk_glyphs, size):
    batch, upem = cjk_glyphs
    grids = [RasterGrid.fixed_tile(tuple(b), size, upem, size) for b in batch.boxes]
    min_x, max_y, scale = grid_anchors(grids)
    return batch.segments, min_x, max_y, f32(scale)


def plain_windows(segs, min_x, max_y, scale, height, width, win_rows=None, offset=(0.0, 0.0)):
    """The port's pack and its plain windowed winding."""
    wr = win_rows or win_rows_for(height)
    win, counts, _, _ = pack_windows(segs, max_y, float(scale), height, win_rows=wr)
    return winding_ref.winding_windows_batch(
        T(win), T(counts), T(min_x), T(max_y), float(scale), height=height, width=width,
        win_rows=wr, sample_offset=offset).numpy()


def unwindowed(segs, min_x, max_y, scale, height, width, offset=(0.0, 0.0)):
    return winding_ref.winding_batch(
        T(np.asarray(segs, f32)), T(min_x), T(max_y), float(scale), height=height,
        width=width, sample_offset=offset).numpy()


def jax_k3(segs, min_x, max_y, scale, height, width, offset=(0.0, 0.0)):
    """K3 in interpret mode, exact, on the reference's own pack with the
    engine's tuning, cropped as the engine crops it. At offset 0 the call
    is the engine's own (no ``sample_offset``), so it shares its compile."""
    import jax.numpy as jnp

    from fontrx.kernels.winding_dense import (
        dense_win_tuning,
        pack_dense_windows,
        winding_dense_win_batch,
    )

    win_rows, groups, seg_chunk = dense_win_tuning(height)
    win, nw, cap = pack_dense_windows(segs, min_x, max_y, float(scale), height,
                                      win_rows=win_rows, seg_chunk=seg_chunk, groups=groups)
    kw = {} if offset == (0.0, 0.0) else dict(sample_offset=offset)
    out = winding_dense_win_batch(
        jnp.asarray(win), jnp.asarray(min_x, jnp.int32), jnp.asarray(max_y, jnp.int32),
        jnp.float32(scale), height=height, width=-(-width // 8) * 8, n_windows=nw, cap=cap,
        interpret=True, exact=True, seg_chunk=seg_chunk, col_block=8, groups=groups,
        win_rows=win_rows, **kw)
    return np.asarray(out)[:, :height, :width]


def assert_same_pack(segs, max_y, scale, height, win_rows):
    """The port's pack holds the reference's live slots, in order, in each
    window, and zeros after them; returns the counts."""
    from fontrx.kernels.winding_dense import pack_dense_windows

    b = len(segs)
    ref, nw, cap = pack_dense_windows(segs, np.zeros(b, np.int32), max_y, float(scale), height,
                                      win_rows=win_rows, groups=128 // win_rows)
    win, counts, nw_port, cap_port = pack_windows(segs, max_y, float(scale), height,
                                                  win_rows=win_rows)
    assert nw_port == nw and counts.shape == (b, nw) and counts.dtype == np.int32
    assert cap_port == max(counts.max(initial=0), 1) and win.shape == (b, nw * cap_port, 3, 2)
    ref = ref.reshape(b, nw, cap, 3, 2)
    win = win.reshape(b, nw, cap_port, 3, 2)
    k = min(cap, cap_port)
    np.testing.assert_array_equal(win[:, :, :k], ref[:, :, :k])
    assert not ref[:, :, k:].any() and not win[:, :, k:].any()
    # a live copy is never all-zero, so the reference's live slots are its
    # nonzero ones, and they come first
    np.testing.assert_array_equal((ref != 0).any(axis=(3, 4)).sum(axis=2), counts)
    return counts


class TestPack:
    @pytest.mark.parametrize("win_rows", [16, 32, 128])
    def test_matches_reference(self, win_rows):
        # 128 px: 8, 4 and 1 windows; the last glyph is empty
        segs = np.concatenate([synthetic(7), np.zeros((1, 280, 3, 2), f32)])
        counts = assert_same_pack(segs, np.full(8, 127), f32(128 / cjk.UPEM), 128, win_rows)
        assert (counts[-1] == 0).all() and (counts[:-1].sum(axis=1) >= 280).all()

    @pytest.mark.parametrize("size", [64, 32])
    def test_cjktest_atlas(self, size):
        """The whole 1024-glyph batch, as the card's run packs it."""
        from fontrx.engine.atlas import pack_charset as jax_pack_charset
        from fontrx.font.font import Font as JaxFont

        font = JaxFont.open(str(CJK))
        batch = jax_pack_charset(font, [0x4E00 + i for i in range(1024)])
        grids = [RasterGrid.fixed_tile(tuple(b), size, font.info.units_per_em, size)
                 for b in np.asarray(batch.boxes)]
        _, max_y, scale = grid_anchors(grids)
        counts = assert_same_pack(np.asarray(batch.segments), max_y, f32(scale), size,
                                  win_rows_for(size))
        # every live segment is in at least one window, some in both
        live = int(np.asarray(batch.seg_counts).sum())
        assert live < counts.sum() < 2 * live

    def test_empty_batch_and_glyph(self):
        segs = np.zeros((2, 128, 3, 2), f32)
        counts = assert_same_pack(segs, np.full(2, 63), f32(64 / cjk.UPEM), 64, 32)
        assert not counts.any()
        win, counts, nw, cap = pack_windows(np.zeros((0, 128, 3, 2), f32), np.zeros(0),
                                            0.03125, 64, win_rows=32)
        assert win.shape == (0, 2, 3, 2) and counts.shape == (0, 2)

    def test_win_rows_are_the_references(self):
        from fontrx.kernels.winding_dense import dense_win_tuning

        for height in range(1, 300):
            assert win_rows_for(height) == dense_win_tuning(height)[0]


class TestPlainVsK3:
    """The plain windowed winding against K3 in interpret mode, bit for bit."""

    @pytest.mark.parametrize("offset", OFFSETS)
    @pytest.mark.parametrize("height,width", SHAPES)
    def test_bit_for_bit(self, height, width, offset):
        segs = synthetic()
        min_x, max_y = anchors(len(segs), height)
        scale = f32(height / cjk.UPEM)
        port = plain_windows(segs, min_x, max_y, scale, height, width, offset=offset)
        np.testing.assert_array_equal(
            port, jax_k3(segs, min_x, max_y, scale, height, width, offset))
        # on these glyphs no root strays: the unwindowed winding is the same
        np.testing.assert_array_equal(
            port, unwindowed(segs, min_x, max_y, scale, height, width, offset))

    @pytest.mark.parametrize("win_rows", [16, 32, 128])
    def test_any_row_height_is_the_unwindowed_map(self, win_rows):
        segs = synthetic()
        min_x, max_y = anchors(3, 80)
        scale = f32(80 / cjk.UPEM)
        np.testing.assert_array_equal(
            plain_windows(segs, min_x, max_y, scale, 80, 72, win_rows, (0.5, -0.25)),
            unwindowed(segs, min_x, max_y, scale, 80, 72, (0.5, -0.25)))


class TestStrayRoot:
    def test_port_drops_what_k3_drops(self, interpret_without_fma, capsys):
        """Two synthetic glyphs and the near-line at 64 px.

        - K2 in interpret mode, the unwindowed port and the oracle
          (``contract=False``) count the near-line's crossings on rows
          32-39, outside its window;
        - the port drops them and equals K3 in interpret mode bit for bit.

        That K3 runs where XLA:CPU emits no fused multiply-add
        (``interpret_without_fma``). Where it may, its code generator fuses
        a multiply and an add in K3's lane-group code, and K3 then also
        finds the near-line's double root on rows 18-22, the rows on which
        ``fma(p1y, p1y, cy * a)`` puts it. That K3 still drops rows 32-39,
        equals the port on the other glyphs and differs from it on no other
        row."""
        import jax.numpy as jnp

        from fontrx.kernels.winding_dense import dense_tuning, winding_dense_batch

        segs, min_x, max_y, scale = stray_batch()
        win, counts, _, _ = pack_windows(segs, max_y, float(scale), 64, win_rows=32)
        assert counts[2].tolist() == [2, 0]

        port = plain_windows(segs, min_x, max_y, scale, 64, 64)
        full = unwindowed(segs, min_x, max_y, scale, 64, 64)
        lane_pack, seg_chunk = dense_tuning(64)
        k2 = np.asarray(winding_dense_batch(
            jnp.asarray(segs), jnp.asarray(min_x), jnp.asarray(max_y), jnp.float32(scale),
            height=64, width=64, interpret=True, exact=True, seg_chunk=seg_chunk, col_block=8,
            lane_pack=lane_pack))[:, :64, :64]
        np.testing.assert_array_equal(full, k2)
        xs = (np.arange(64).astype(f32) / scale)[None, :]
        ys = ((63 - np.arange(64)).astype(f32) / scale)[:, None]
        np.testing.assert_array_equal(full[2], oracle.winding_at(segs[2], xs, ys, contract=False))
        strays = full[2, 32:] != 0
        assert strays.any() and not port[2, 32:].any()
        np.testing.assert_array_equal(port[2, :32], full[2, :32])

        np.testing.assert_array_equal(port, interpret_without_fma())

        k3 = jax_k3(segs, min_x, max_y, scale, 64, 64)
        assert not k3[2, 32:].any()
        np.testing.assert_array_equal(port[:2], k3[:2])
        # the rows where a fused p1y * p1y + cy * a leaves a discriminant
        # >= 0 and the rounded product does not
        p0y, p1y, p2y = near_line()[0, :, 1]
        cy = (63 - np.arange(64)).astype(f32) / scale
        a = p0y - f32(2) * p1y + p2y
        rounded = cy * a + p1y * p1y - p0y * p2y
        fused = (np.float64(p1y) ** 2 + cy * a).astype(f32) - p0y * p2y
        fma_rows = np.nonzero((fused >= 0) & (rounded < 0))[0].tolist()
        assert fma_rows == [18, 19, 20, 21, 22]
        assert set(np.nonzero((port != k3).any(axis=(0, 2)))[0]) <= set(fma_rows)
        with capsys.disabled():
            print(f"\nnear-line: {int(strays.sum())} pixels on rows "
                  f"{(32 + np.nonzero(strays.any(axis=1))[0]).tolist()} dropped by the port and "
                  f"by K3; {int((port != k3).sum())} differ from K3 where XLA:CPU may fuse "
                  f"multiply-adds, on rows {np.nonzero((port != k3).any(axis=(0, 2)))[0].tolist()}")


class TestEngine:
    @pytest.mark.parametrize("size", [64, 32])
    def test_matches_jax_engine(self, size):
        """``pack_windows`` + ``winding_batch(windows=)``, both engines."""
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine as JaxEngine

        segs = synthetic()
        min_x, max_y = anchors(3, size)
        scale = f32(size / cjk.UPEM)
        je = JaxEngine(backend="interpret")
        jw = je.pack_windows(segs, min_x, max_y, float(scale), height=size)
        want = np.asarray(je.winding_batch(jnp.asarray(segs), min_x, max_y, scale, height=size,
                                           width=size, windows=jw))
        engine = RasterEngine("cpu")
        wins = engine.pack_windows(segs, min_x, max_y, scale, height=size)
        assert (wins.n_windows, wins.win_rows, wins.height) == (jw.n_windows, jw.win_rows, size)
        assert wins.segments_win.device.type == "cpu" and wins.counts.dtype == torch.int32
        got = engine.winding_batch(segs, min_x, max_y, scale, height=size, width=size,
                                   windows=wins).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("size", [64, 32])
    @pytest.mark.parametrize("offset", [(0.0, 0.0), (0.25, 0.75)])
    def test_oracle(self, cjk_glyphs, size, offset):
        segs, min_x, max_y, scale = cjk_inputs(cjk_glyphs, size)
        engine = RasterEngine("cpu")
        wins = engine.pack_windows(segs, min_x, max_y, scale, height=size)
        out = engine.winding_batch(segs, min_x, max_y, scale, height=size, width=size,
                                   sample_offset=offset, windows=wins).numpy()
        for i in range(len(segs)):
            xs = ((min_x[i] + np.arange(size)).astype(f32) + f32(offset[0])) / scale
            ys = ((max_y[i] - np.arange(size)).astype(f32) + f32(offset[1])) / scale
            np.testing.assert_array_equal(
                out[i], oracle.winding_at(segs[i], xs[None, :], ys[:, None], contract=False))

    def test_no_pack_where_the_reference_packs_none(self):
        engine = RasterEngine("cpu")
        segs = synthetic(2)
        min_x, max_y = anchors(2, 64)
        assert engine.pack_windows(segs[:, :127], min_x, max_y, 0.03125, height=64) is None
        assert engine.pack_windows(segs, min_x, max_y, 0.0625, height=129) is None
        assert engine.pack_windows(segs[:, :128], min_x, max_y, 0.03125, height=128) is not None

    def test_routes(self, monkeypatch):
        """The windowed kernel runs for a pack of this height on a tile of
        at most 128 x 128, and the unwindowed one otherwise."""
        engine = RasterEngine("cpu")
        segs = synthetic(2)
        segs[1, :2] = near_line()
        segs[1, 2:] = 0
        min_x, max_y = anchors(2, 64)
        scale = f32(64 / cjk.UPEM)
        wins = engine.pack_windows(segs, min_x, max_y, scale, height=64)
        plain = engine.winding_batch(segs, min_x, max_y, scale, height=64, width=64).numpy()

        def refuse(*args, **kwargs):
            raise AssertionError("wrong route")

        with monkeypatch.context() as m:
            m.setattr(winding, "winding_batch", refuse)
            windowed = engine.winding_batch(segs, min_x, max_y, scale, height=64, width=64,
                                            windows=wins).numpy()
        assert (windowed != plain).any()  # the near-line's strays
        monkeypatch.setattr(winding, "winding_windows_batch", refuse)
        for h, w in ((48, 64), (64, 129)):  # another height; too wide
            np.testing.assert_array_equal(
                engine.winding_batch(segs, min_x, max_y, scale, height=h, width=w,
                                     windows=wins).numpy(),
                unwindowed(segs, min_x, max_y, scale, h, w))


class TestWrapper:
    def test_batch_size_mismatch_raises(self):
        engine = RasterEngine("cpu")
        segs = synthetic(3)
        min_x, max_y = anchors(3, 64)
        wins = engine.pack_windows(segs[:2], min_x[:2], max_y[:2], 0.03125, height=64)
        with pytest.raises(ValueError, match="packed for 2 glyphs"):
            engine.winding_batch(segs, min_x, max_y, 0.03125, height=64, width=64,
                                 windows=wins)

    @pytest.mark.parametrize("oy", [1.0, -1.0])
    def test_offset_within_the_margin_runs(self, oy):
        segs = synthetic(2)
        min_x, max_y = anchors(2, 32)
        scale = f32(32 / cjk.UPEM)
        np.testing.assert_array_equal(
            plain_windows(segs, min_x, max_y, scale, 32, 32, offset=(0.5, oy)),
            unwindowed(segs, min_x, max_y, scale, 32, 32, (0.5, oy)))

    @pytest.mark.parametrize("oy", [1.5, -1.25, float("nan")])
    def test_offset_beyond_the_margin_raises(self, oy):
        engine = RasterEngine("cpu")
        segs = synthetic(2)
        min_x, max_y = anchors(2, 64)
        wins = engine.pack_windows(segs, min_x, max_y, 0.03125, height=64)
        with pytest.raises(ValueError, match="margin"):
            engine.winding_batch(segs, min_x, max_y, 0.03125, height=64, width=64,
                                 sample_offset=(0.0, oy), windows=wins)

    def test_bad_stream_raises(self):
        segs = synthetic(2)
        min_x, max_y = anchors(2, 64)
        win, counts, _, _ = pack_windows(segs, max_y, 0.03125, 64, win_rows=32)
        args = (T(min_x), T(max_y), 0.03125)
        with pytest.raises(ValueError, match="do not cover"):
            winding.winding_windows_batch(T(win), T(counts), *args, height=64, width=64,
                                          win_rows=16)
        with pytest.raises(ValueError, match="counts"):
            winding.winding_windows_batch(T(win), T(counts[:1]), *args, height=64, width=64,
                                          win_rows=32)
        with pytest.raises(ValueError, match="segments_win"):
            winding.winding_windows_batch(T(win[:, :-1]), T(counts), *args, height=64,
                                          width=64, win_rows=32)

    def test_failed_build_raises(self, tmp_path, monkeypatch):
        """No fallback: where the library cannot be built, the launch raises
        and counts nothing."""
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "nvcc_path", lambda: None)
        monkeypatch.setattr(_build, "_loaded", {})
        segs = synthetic(1)
        min_x, max_y = anchors(1, 64)
        win, counts, nw, cap = pack_windows(segs, max_y, 0.03125, 64, win_rows=32)
        before = winding.windows_launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            winding.launch_windows(T(win), T(counts), T(min_x), T(max_y), f32(0.03125), 1, nw,
                                   cap, 32, 64, 64)
        assert winding.windows_launches == before

    def test_cpu_tensor_runs_plain_version(self):
        segs = synthetic(2)
        min_x, max_y = anchors(2, 32)
        win, counts, _, _ = pack_windows(segs, max_y, 0.015625, 32, win_rows=16)
        before = winding.windows_launches
        out = winding.winding_windows_batch(T(win), T(counts), T(min_x), T(max_y), 0.015625,
                                            height=32, width=32, win_rows=16)
        assert winding.windows_launches == before
        np.testing.assert_array_equal(out.numpy(), plain_windows(
            segs, min_x, max_y, f32(0.015625), 32, 32))


class TestBench:
    @pytest.mark.parametrize("b,n,seed", [(16, 288, 7), (5, 280, 3)])
    def test_make_batch_is_the_references(self, b, n, seed):
        np.testing.assert_array_equal(cjk.make_batch(b, n, seed), ref_cjk.make_batch(b, n, seed))
        assert cjk.UPEM == ref_cjk.UPEM

    def test_unsorted_strokes(self):
        mine = cjk.synthetic_strokes(np.random.default_rng(4), 42, y_sorted=False)
        theirs = ref_cjk.synthetic_strokes(np.random.default_rng(4), 42, y_sorted=False)
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.requires_cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("offset", [(0.0, 0.0), (0.25, 0.75), (0.0, -1.0)])
    @pytest.mark.parametrize("height,width", SHAPES)
    def test_kernel_matches_plain_and_winding_cu(self, cuda, cjk_glyphs, height, width, offset):
        for segs, min_x, max_y, scale in (
                (synthetic(), *anchors(3, height), f32(height / cjk.UPEM)),
                cjk_inputs(cjk_glyphs, height)):
            wr = win_rows_for(height)
            win, counts, _, _ = pack_windows(segs, max_y, float(scale), height, win_rows=wr)
            args = [T(a).to(cuda) for a in (win, counts, min_x, max_y)]
            before, plain_before = winding.windows_launches, winding.launches
            out = winding.winding_windows_batch(*args, float(scale), height=height, width=width,
                                                win_rows=wr, sample_offset=offset)
            torch.cuda.synchronize()
            assert (winding.windows_launches, winding.launches) == (before + 1, plain_before)
            want = winding_ref.winding_windows_batch(*args, float(scale), height=height,
                                                     width=width, win_rows=wr,
                                                     sample_offset=offset)
            assert torch.equal(out, want)
            full = winding.winding_batch(T(np.asarray(segs)).to(cuda), *args[2:], float(scale),
                                         height=height, width=width, sample_offset=offset)
            assert torch.equal(out, full)

    def test_stray_root_on_card(self, cuda):
        segs = np.zeros((1, 128, 3, 2), f32)
        segs[0, :2] = near_line()
        min_x, max_y = anchors(1, 64)
        scale = f32(64 / cjk.UPEM)
        engine = RasterEngine(cuda)
        wins = engine.pack_windows(segs, min_x, max_y, scale, height=64)
        out = engine.winding_batch(segs, min_x, max_y, scale, height=64, width=64,
                                   windows=wins).cpu().numpy()
        np.testing.assert_array_equal(out, plain_windows(segs, min_x, max_y, scale, 64, 64))
        assert (out != unwindowed(segs, min_x, max_y, scale, 64, 64)).any()

    def test_wrapper_rejects_bad_inputs(self, cuda):
        segs = torch.zeros((2, 128, 3, 2), device=cuda)
        counts = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
        anchors_ = torch.zeros(2, dtype=torch.int32, device=cuda)
        kw = dict(height=64, width=64, win_rows=32)
        with pytest.raises(TypeError):
            winding.winding_windows_batch(segs, counts.long(), anchors_, anchors_, 1.0, **kw)
        with pytest.raises(ValueError):
            winding.winding_windows_batch(segs, counts, anchors_[:1], anchors_, 1.0, **kw)
        with pytest.raises(ValueError):
            winding.winding_windows_batch(segs, counts.cpu(), anchors_, anchors_, 1.0, **kw)


# -- the kernel's row cull inside K3's windows (csrc/winding.cu) --------------

@pytest.fixture
def one_torch_thread():
    """Small tensors: torch on one thread, so parallel test workers do not
    spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sliver_glyphs(size, oy):
    """Two glyphs of ulp slivers on the rows of a ``size`` px tile, and the
    em-space near-lines, as a zero-padded batch with their anchors."""
    cy = wt.row_ys(size - 1, size, oy, f32(size / cjk.UPEM))
    qs = [wt.em_slivers(cy, seed=1, n=40), wt.em_slivers(cy, seed=2, n=40), wt.em_near_lines()]
    segs = np.zeros((len(qs), 128, 3, 2), f32)
    for i, q in enumerate(qs):
        segs[i, : len(q)] = q.reshape(-1, 3, 2)
    return segs


def window_batches(cjk_glyphs, size, oy):
    """(name, segments, min_x, max_y, scale) of the windowed cull's cases."""
    scale = f32(size / cjk.UPEM)
    yield "strokes", synthetic(2), *anchors(2, size), scale
    segs, min_x, max_y, _ = stray_batch()
    yield "near-line", segs, min_x, max_y - 64 + size, scale
    yield "slivers", sliver_glyphs(size, oy), *anchors(3, size), scale
    yield "cjktest", *cjk_inputs(cjk_glyphs, size)


@pytest.mark.parametrize("oy", wt.CULL_OFFSETS)
class TestCull:
    @pytest.mark.parametrize("size", [64, 32])
    def test_keeps_every_crossing_in_its_windows(self, cjk_glyphs, size, oy, one_torch_thread):
        """Each window's live copies, on its rows below the height, in blocks
        of the plan's rows (for this batch and for a 1024-glyph atlas) and of
        5: the cull keeps every crossing that the
        plain windowed version counts, so it drops none and adds no row the
        stream left out."""
        wr = win_rows_for(size)
        atlas_rows = wt.launch_plan(1024, size, size, wr)[0]
        for name, segs, min_x, max_y, scale in window_batches(cjk_glyphs, size, oy):
            win, counts, nw, cap = pack_windows(segs, max_y, float(scale), size, win_rows=wr)
            copies = win.reshape(len(segs), nw, cap, 6)
            plan_rows = wt.launch_plan(len(segs), size, size, wr)[0]
            for b in range(len(segs)):
                for w in range(nw):
                    r0 = w * wr
                    cy = wt.row_ys(max_y[b] - r0, min(wr, size - r0), oy, scale)
                    for rows in {atlas_rows, plan_rows, 5}:
                        assert wt.dropped_crossings(copies[b, w, : counts[b, w]], cy, rows) == 0, \
                            (name, b, w, rows)

    def test_windows_hold_crossings(self, cjk_glyphs, oy, one_torch_thread):
        """The cases are not empty: the windows' copies cross their rows."""
        for name, segs, min_x, max_y, scale in window_batches(cjk_glyphs, 64, oy):
            out = plain_windows(segs, min_x, max_y, scale, 64, 64, offset=(0.0, oy))
            assert out.any(), name


@pytest.mark.requires_cuda
class TestWindowsPlanOnCard:
    @pytest.mark.parametrize("b,h,w,win_rows,path", [c for c in wt.PLAN_CASES if c[3]])
    def test_paths(self, cuda, b, h, w, win_rows, path):
        """Each labelled windowed path's plan from the library, and its
        kernel equal to the plain version, at a few sample offsets."""
        assert wt.plan_path(winding.plan(b, h, w, win_rows), h, w, win_rows) == path
        segs = synthetic(2)
        segs[1, :2] = near_line()
        segs[1, 2:] = 0
        segs = np.resize(segs, (b, *segs.shape[1:]))
        scale = f32(64 / cjk.UPEM)  # 64 px glyphs, their middle rows and columns in view
        min_x = np.full(b, 32 - w // 2, np.int32)
        max_y = np.full(b, 31 + h // 2, np.int32)
        win, counts, _, _ = pack_windows(segs, max_y, float(scale), h, win_rows=win_rows)
        args = [T(a).to(cuda) for a in (win, counts, min_x, max_y)]
        for offset in [(0.0, 0.0), (0.25, -1 / 3), (-0.5, 1.0)]:
            before = winding.windows_launches
            out = winding.winding_windows_batch(*args, float(scale), height=h, width=w,
                                                win_rows=win_rows, sample_offset=offset)
            torch.cuda.synchronize()
            assert winding.windows_launches == before + 1
            want = winding_ref.winding_windows_batch(*args, float(scale), height=h, width=w,
                                                     win_rows=win_rows, sample_offset=offset)
            assert torch.equal(out, want) and bool((out != 0).any())

    @pytest.mark.parametrize("oy", [0.0, 0.25, -1 / 3, 1.0])
    @pytest.mark.parametrize("size", [64, 32])
    def test_slivers_and_near_lines(self, cuda, size, oy):
        """The row cull's hard cases through the windowed entry: ulp slivers
        and near-lines, the stray-root glyph among them."""
        segs, min_x, max_y, scale = stray_batch()
        segs = np.concatenate([segs[2:, :128], sliver_glyphs(size, oy)])
        min_x, max_y = anchors(len(segs), size)
        scale = f32(size / cjk.UPEM)
        wr = win_rows_for(size)
        win, counts, _, _ = pack_windows(segs, max_y, float(scale), size, win_rows=wr)
        args = [T(a).to(cuda) for a in (win, counts, min_x, max_y)]
        kw = dict(height=size, width=size, win_rows=wr, sample_offset=(0.0, oy))
        out = winding.winding_windows_batch(*args, float(scale), **kw)
        want = winding_ref.winding_windows_batch(*args, float(scale), **kw)
        assert torch.equal(out, want) and bool((out != 0).any())
