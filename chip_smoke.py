"""Drive fontrx_torch's glyph fill, window-packed atlas, tile coverage, SDF
atlas, Loop-Blinn atlas, direct page and interactive MSAA paths once on one
CUDA card, and check them.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``fontrx_torch/csrc`` into ``build/`` (one
``nvcc`` per source, all started together), packs two atlases with the
port's own front end, then drives the paths through the entry points a user
calls, each with the kernels' launch counts set to 0 just before it and read
just after:

- **winding fill**:
  1. the 94 printable ASCII glyphs of DejaVu Sans at 256 px on 256 x 256
     tiles, through ``RasterEngine.winding_batch``;
  2. the 1024 glyphs of ``tests/data/cjktest.ttf`` (200-330 segments each)
     at 64 px on 64 x 64 tiles;
  3. the README quick start on 'A' at 256 px: ``winding_glyph`` -> ``fill``
     -> QOI encode -> decode;
  4. ``fontrx_torch.entry.entry()``'s raster step on its example batch;
- **window-packed atlas** (K3): ``RasterEngine.pack_windows`` then
  ``winding_batch(windows=...)`` on cjk64's batch at 64 and at 32 px and on
  the reference's CJK benchmark batch (``benchmarks/cjk.py:112-160``: 1000
  glyphs x 288 segments, seed 7, x-sorted per glyph) at 64 and at 32 px:
  four launches of ``winding_windows()``, none of ``winding()``;
- **tile coverage**: 2 x 2 supersampled coverage of both atlases through
  ``RasterEngine.coverage_batch``, then ``coverage_to_gray``;
- **SDF atlas** (BASELINE config 4): signed distance fields (8 px spread)
  of ascii256, cjk64 and cjk32 (the CJK batch on 32 x 32 grids) through
  ``RasterEngine.sdf_batch`` (the winding kernel for the sign, then the
  distance kernel), then ``sdf_to_u8``;
- **Loop-Blinn atlas** (BASELINE config 3): the 94 printable ASCII glyphs of
  DejaVu Sans triangulated by ``fontrx_torch.geometry``, padded to one
  triangle count, at 128 px on 128 x 128 tiles through
  ``loopblinn.loopblinn_batch``, and 'g' at 128 px through
  ``loopblinn.loopblinn_fill``;
- **direct page** (BASELINE config 5): twenty lines of text on a 1920 x 1080
  page through ``fontrx_torch.scene.interactive.InteractiveSession`` exactly
  as ``benchmarks/configs.py:276-295`` drives it: ``frame()``, then 30
  zoom/pan events with a frame after each; a 256-row band through its
  renderer, then the ``d`` and ``t`` toggles once each through
  ``display_frame()``; then the stress page (``benchmarks/stress.py:93-124``):
  a 10k-character text on a 3840 x 2160 page zoomed out by 8 steps, and five
  frames zooming on from there, through ``PageRenderer.render_direct``;
- **page MSAA** (the session's ``m`` key): config 5's 31 frames again in a
  session with ``m`` pressed (the wide route: K8's pairs), a narrow session
  (640 x 480, six lines, ``m`` pressed, three events: the four-pass route)
  and the stress page's 6 frames through ``render_direct(msaa=True)``.

It then checks every result: each kernel against its plain PyTorch version
on every pixel (the SDF as int32 bit patterns; the Loop-Blinn atlas also
against the plain version on the CPU; the windowed atlases also against
``winding.cu`` on the unwindowed batch), the atlases against the NumPy oracle
(``contract=False``; for the SDF, its sign) on sampled glyphs, the quick
start against the oracle's fill, the Loop-Blinn fill against the
winding fill at tie-free sample offsets on the glyphs of the JAX package's
own test (``tests/test_geometry.py``), and the pages against the plain
version (every frame, whole; config 5's band, gray and transparent frame; a
128-row band of the 4K page), the winding kernel at batch 1 (config 5's first
frame, whose transform is exact) and the oracle (every 64th row of that
frame), the MSAA frames against the plain version (every frame, whole), the
first config 5 and narrow MSAA frames against four winding-kernel passes at
the sample offsets, and config 5's against the oracle at the four offsets
(every 128th row from row 32; the oracle runs a row per process), and
times each kernel and its plain version with CUDA events: the kernel both
replayed from a CUDA graph (its device time) and called through its wrapper
(what a caller waits for, host launch overhead included), and each session's
frames as its user sees them (``stats()``: the page to the host included).
Any failure raises and exits non-zero. The last two lines are JSON: the kernels' record (each
kernel's times beside its bound, from ``fontrx_torch.bound``, and the host
pack times), then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pathlib
import statistics
import subprocess
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from itertools import repeat

import numpy as np
import torch

from fontrx_torch.bench.cjk import UPEM, make_batch
from fontrx_torch.bound import (
    bound_ms, loopblinn_bytes, loopblinn_work, page_bytes, page_msaa_bytes, page_msaa_work,
    page_work, sdf_work, solve_work, window_bytes, window_work)
from fontrx_torch.convert import grid_anchors, packed_to_device, to_device, triangles_to_device
from fontrx_torch.device import probe, require_cuda
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.entry import entry
from fontrx_torch.font.font import Font
from fontrx_torch.geometry import TriangulatedGlyph
from fontrx_torch.io import qoi
from fontrx_torch.kernels import (
    _build, coverage, coverage_ref, loopblinn, loopblinn_ref, oracle, page, page_ref, sdf,
    sdf_ref, winding, winding_ref)
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import glyph_segments, pack_glyph, xsort_segments
from fontrx_torch.scene.interactive import InteractiveSession
from fontrx_torch.scene.layout import layout_text
from fontrx_torch.scene.page import PageRenderer
from fontrx_torch.scene.transform import ViewTransform

ROOT = pathlib.Path(__file__).resolve().parent
DEJAVU = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
CJK = ROOT / "tests" / "data" / "cjktest.ttf"

# (name, font, chars, font size = tile size)
ATLASES = (
    ("ascii256", DEJAVU, list(range(33, 127)), 256),
    ("cjk64", CJK, [0x4E00 + i for i in range(1024)], 64),
)
ORACLE_STRIDE = 13           # winding: every 13th glyph, as bench.py samples
COVERAGE_ORACLE_STRIDE = 52  # coverage costs the oracle k*k maps a glyph
SAMPLES = 2                  # k of the k x k coverage (the reference's MSAA workloads)
# (name, packed atlas, font size = tile size): BASELINE config 4, "SDF atlas
# for 1000 CJK glyphs at 32/64px", beside the ASCII headline atlas
SDF_ATLASES = (("ascii256", "ascii256", 256), ("cjk64", "cjk64", 64), ("cjk32", "cjk64", 32))
SDF_ORACLE_STRIDE = 52
# the window-packed atlas (K3): cjk64's batch at 64 and 32 px, and the
# reference's CJK benchmark batch (benchmarks/cjk.py:112-160, atlas(): 1000
# glyphs x 288 segments, seed 7, x-sorted per glyph, min_x 0, max_y size - 1)
# at 64 and 32 px
WINDOW_SIZES = (64, 32)
SYNTH_GLYPHS, SYNTH_SEGMENTS = 1000, 288
WINDOW_ORACLE_STRIDE = 52
# BASELINE config 3 (benchmarks/configs.py:138-197): the printable ASCII
# glyphs of DejaVu Sans, triangulated, at 128 px on 128 x 128 tiles
LB_CHARS = list(range(33, 127))
LB_SIZE = 128
# the JAX package's test of the mesh fill against the winding fill
# (tests/test_geometry.py::test_fill_matches_winding): these glyphs at 64 px,
# sampled at tie-free offsets
LB_WINDING_CHARS = "AOBg8@&WQ%"
LB_WINDING_SIZE = 64
LB_WINDING_OFFSET = (1 / 3, 1 / 3)
# BASELINE config 5 (benchmarks/configs.py:276-295): twenty lines on a
# 1920 x 1080 page in an interactive session, then 30 zoom/pan events; and
# the stress page
# (benchmarks/stress.py:93-124): the line below repeated to 10k characters
# on a 3840 x 2160 page, zoomed out by 8 steps, then five frames zooming in
CONFIG5_TEXT = "\n".join(
    "The quick brown fox jumps over the lazy dog 0123456789" for _ in range(20))
CONFIG5_SIZE = (1920, 1080)
CONFIG5_EVENTS = tuple(("scroll", 0.5 if i % 2 else -0.5, (0.1, 0.1)) if i % 3 == 0
                       else ("drag", 0.01, 0.005) for i in range(30))
STRESS_LINE = "The quick brown fox jumps over the lazy dog. 0123456789 "
STRESS_TEXT = "\n".join(STRESS_LINE for _ in range(10000 // len(STRESS_LINE)))
STRESS_SIZE = (3840, 2160)
PAGE_BAND = (400, 256)        # config 5's band: rows [400, 656)
STRESS_REF_BAND = (1016, 128)  # the 4K page's rows held to the plain version
PAGE_ORACLE_STRIDE = 64
# the MSAA oracle's rows of config 5's first MSAA frame: every 128th from 32
MSAA_ORACLE_ROWS = range(32, CONFIG5_SIZE[1], 128)
# a session below the wide route: six lines on 640 x 480, m pressed, three events
NARROW_TEXT = "\n".join(
    "The quick brown fox jumps over the lazy dog 0123456789" for _ in range(6))
NARROW_SIZE = (640, 480)
NARROW_EVENTS = (("scroll", -0.5, (0.1, 0.1)), ("drag", 0.01, 0.005), ("scroll", 0.5, (0.0, 0.2)))

KERNELS = (winding, coverage, sdf, loopblinn, page)


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for module in KERNELS:
        module.launches = 0
    page.msaa_launches = 0
    winding.windows_launches = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def cuda_ms(fn, *, inner: int, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, in ms per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, *, calls: int = 20) -> float:
    """Device ms per call of ``fn``: CUDA-event timings of a CUDA graph that
    replays ``calls`` calls, so no host launch overhead is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up before capture, on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, inner=1) / calls


def bound(batch, args, out, *, row_offsets, columns: int, samples_per_pixel: int):
    """The least time the card could take for a kernel's work, in ms, what
    binds it, and the FP32 operations and crossings counted: the inputs read
    once and the output written once at the memory rate, against the
    operations these inputs need (``fontrx_torch.bound``) and one per sample
    at the FP32 rate."""
    seg, min_x, max_y, scale = args
    nbytes = sum(t.numel() * t.element_size() for t in (seg, min_x, max_y, out))
    ops, crossings = solve_work(batch.segments, batch.seg_counts, max_y.cpu().numpy(), scale,
                                height=out.shape[1], row_offsets=row_offsets, columns=columns)
    ops += out.numel() * samples_per_pixel
    return (*bound_ms(nbytes, ops), ops, crossings)


def sdf_bound(args, out):
    """The SDF distance kernel's bound, as ``bound``: the segments, anchors
    and winding map read once and the output written once, against the
    operations of the (segment, pixel) pairs the function needs
    (``fontrx_torch.bound.sdf_work``, counted on the card)."""
    seg, min_x, max_y, scale = args
    nbytes = sum(t.numel() * t.element_size() for t in (seg, min_x, max_y, out))
    nbytes += out.numel() * 4  # the int32 winding map
    ops, pairs = sdf_work(seg, min_x, max_y, scale, height=out.shape[1], width=out.shape[2])
    return (*bound_ms(nbytes, ops), ops, pairs)


def coverage_oracle(segments, grid: RasterGrid, k: int) -> np.ndarray:
    """The oracle's coverage: nonzero samples over the k x k lattice,
    counted, times float32(1 / k^2)."""
    count = np.zeros((grid.height, grid.width), np.int32)
    scale = np.float32(grid.scale)
    for ox, oy in coverage_ref.sample_offsets(k):
        xs = ((grid.min_x + np.arange(grid.width)).astype(np.float32) + ox) / scale
        ys = ((grid.max_y - np.arange(grid.height)).astype(np.float32) + oy) / scale
        count += oracle.winding_at(segments, xs[None, :], ys[:, None], contract=False) != 0
    return count.astype(np.float32) * coverage_ref.inv_samples(k)


def build_kernels() -> None:
    """Build every kernel library at once, one nvcc process per source."""
    names = sorted(_build._SIGNATURES)

    def timed(name):
        cached = _build.library_path(name).exists()
        t0 = time.perf_counter()
        path = _build.build(name)
        return path, time.perf_counter() - t0, cached

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        results = dict(zip(names, pool.map(timed, names)))
    for name, (path, secs, cached) in results.items():
        _build.load(name)
        print(f"build: {path.relative_to(ROOT)} in {secs:.2f} s"
              + (" (already built)" if cached else ""))
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s")


def load_atlas(font_path, chars, size):
    t0 = time.perf_counter()
    font = Font.open(font_path)
    batch = pack_charset(font, chars)
    pack_s = time.perf_counter() - t0
    grids = [
        RasterGrid.fixed_tile(tuple(box), size, font.info.units_per_em, size)
        for box in np.asarray(batch.boxes)
    ]
    return batch, grids, pack_s


def load_meshes(font_path, chars, size):
    """Triangulate ``chars`` and pad their meshes to one triangle count, as
    ``benchmarks/configs.py:152-176`` does: float32 ``[B, M, 3, 4]`` and
    int32 ``[B, M]``, the fixed ``size`` grids, the host time."""
    t0 = time.perf_counter()
    font = Font.open(font_path)
    glyphs = [font.get_glyph(c)[0] for c in chars]
    meshes = [TriangulatedGlyph.from_glyph(g) for g in glyphs]
    tris, classes = loopblinn.pack_meshes(meshes)
    pack_s = time.perf_counter() - t0
    grids = [RasterGrid.fixed_tile((g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                                   size, font.info.units_per_em, size) for g in glyphs]
    return tris, classes, grids, pack_s


def open_session(font, text, size, dev):
    """Open an interactive session on ``text`` and compact its segment stream
    (once per layout); returns the session and the host time."""
    t0 = time.perf_counter()
    sess = InteractiveSession(font, text, *size, dev)
    sess.renderer.page_inputs(sess.view)
    torch.cuda.synchronize()
    return sess, time.perf_counter() - t0


def run_events(sess, events):
    """A frame, then ``events`` with a frame after each: the frames (host
    arrays) and the view of each."""
    frames, views = [sess.frame()], [sess.view]
    for name, *args in events:
        getattr(sess, name)(*args)
        frames.append(sess.frame())
        views.append(sess.view)
    return frames, views


def stress_views(upem):
    """The stress page's first view, zoomed out by 8 steps, and its five
    frames zooming on (benchmarks/stress.py:108-124)."""
    view = ViewTransform.init(upem, *STRESS_SIZE).zoomed(-8.0, (0.0, 0.0))
    return [view] + [view.zoomed(0.01 * (i + 1), (0.0, 0.0)) for i in range(5)]


def load_page(font, text, size, view, dev):
    """Lay ``text`` out, make its page renderer and compact its segment
    stream (once per layout); returns the renderer and the host time."""
    t0 = time.perf_counter()
    renderer = PageRenderer(font, layout_text(font, text), *size, dev)
    renderer.page_inputs(view)
    torch.cuda.synchronize()
    return renderer, time.perf_counter() - t0


def winding_page(inputs, page_h, page_w, sample_offset=(0.0, 0.0)):
    """The page from the winding kernel at batch 1 on the page-space stream
    (anchors 0 and ``page_h - 1``, scale 1) at ``sample_offset``: int32
    ``[page_h, page_w]``. It solves every (segment, row) pair, so it is the
    page where no root strays."""
    flat = page_ref.transform_segments(*inputs)[None].contiguous()
    dev = flat.device
    return winding.winding_batch(
        flat, torch.zeros(1, dtype=torch.int32, device=dev),
        torch.full((1,), page_h - 1, dtype=torch.int32, device=dev), 1.0,
        height=page_h, width=page_w, sample_offset=sample_offset)[0]


def msaa_from_windings(windings):
    """The MSAA pixel from the four samples' int32 windings: nonzero ones
    counted, times 255, floor-divided by 4."""
    return sum(w != 0 for w in windings) * 255 // 4  # sum() starts at int 0


def oracle_row(q, xs, y):
    """The oracle's winding (``contract=False``) of page-space segments ``q``
    on one sample row ``y`` at columns ``xs``: int32 ``[1, len(xs)]``."""
    return oracle.winding_at(q, xs[None, :], np.float32([[y]]), contract=False)


def oracle_rows(q, page_w, rows):
    """The oracle on sample rows ``rows``, ``(y, ox)`` each, at columns
    ``x = f32(c) + ox``: int32 ``[len(rows), page_w]``. A row per process of
    a pool as wide as the host's cores (forked: the workers run NumPy only),
    a pool that ends with the call."""
    cols = np.arange(page_w).astype(np.float32)
    with ProcessPoolExecutor(os.cpu_count() or 1,
                             mp_context=multiprocessing.get_context("fork")) as pool:
        return np.concatenate(list(pool.map(
            oracle_row, repeat(q), [cols + np.float32(ox) for _, ox in rows],
            [y for y, _ in rows])))


def main() -> None:
    dev = require_cuda()
    print("toolchain:", json.dumps(probe()))
    build_kernels()

    atlases, pack_s = {}, {}
    for name, font_path, chars, size in ATLASES:
        batch, grids, pack_s[name] = load_atlas(font_path, chars, size)
        atlases[name] = (batch, grids, size)
        print(f"{name}: segments {list(batch.segments.shape)}, host pack "
              f"(font parse + {len(chars)} glyphs, Python path) {pack_s[name]:.3f} s")

    engine = RasterEngine(device=dev)

    # --- winding fill path, once, through the user-facing entry points ----
    reset_counts()
    outputs = {}
    for name, (batch, grids, size) in atlases.items():
        before = winding.launches
        outputs[name] = engine.winding_batch(
            batch.segments, *grid_anchors(grids), height=size, width=size)
        torch.cuda.synchronize()
        check(winding.launches > before, f"{name} did not launch the winding kernel")

    font = Font.open(DEJAVU)
    glyph, _advance = font.get_glyph("A")
    packed = pack_glyph(glyph)
    grid = RasterGrid.for_glyph_box(packed.box, 256, font.info.units_per_em)
    before = winding.launches
    fill = engine.fill(engine.winding_glyph(packed.segments, grid)).cpu().numpy()
    rgb = np.repeat(fill[:, :, None], 3, axis=2)
    decoded = qoi.decode(qoi.encode_rgb(rgb))
    check(winding.launches > before, "quick start did not launch the winding kernel")

    before = winding.launches
    fn, example_args = entry()
    mask = fn(*example_args)
    torch.cuda.synchronize()
    check(winding.launches > before, "entry() did not launch the winding kernel")
    winding_launches = winding.launches
    print(f"winding path: {winding_launches} winding kernel launches, "
          f"{coverage.launches} coverage")

    # --- window-packed atlas path (K3), once ----------------------------------
    cjk_batch = atlases["cjk64"][0]
    cjk_upem = Font.open(CJK).info.units_per_em
    synth = np.stack([xsort_segments(s) for s in make_batch(SYNTH_GLYPHS, SYNTH_SEGMENTS)])
    win_batches = {}
    for size in WINDOW_SIZES:
        grids = [RasterGrid.fixed_tile(tuple(box), size, cjk_upem, size)
                 for box in np.asarray(cjk_batch.boxes)]
        win_batches[f"cjk{size}"] = (cjk_batch.segments, *grid_anchors(grids), size)
        win_batches[f"synth{size}"] = (
            synth, np.zeros(SYNTH_GLYPHS, np.int32), np.full(SYNTH_GLYPHS, size - 1, np.int32),
            float(np.float32(size / UPEM)), size)
    windows = {}
    for name, (segs, min_x, max_y, scale, size) in win_batches.items():
        t0 = time.perf_counter()
        windows[name] = engine.pack_windows(segs, min_x, max_y, scale, height=size)
        torch.cuda.synchronize()
        pack_s[f"{name}_windows"] = time.perf_counter() - t0
        check(windows[name] is not None, f"{name}: pack_windows packed nothing")
    reset_counts()
    win_outputs = {}
    for name, (segs, min_x, max_y, scale, size) in win_batches.items():
        win_outputs[name] = engine.winding_batch(segs, min_x, max_y, scale, height=size,
                                                 width=size, windows=windows[name])
    torch.cuda.synchronize()
    windows_launches = winding.windows_launches
    check(windows_launches == len(win_batches),
          f"the windowed path launched winding_windows() {windows_launches} times")
    check(winding.launches == 0, "the windowed path launched winding()")
    print(f"windowed path: {windows_launches} winding_windows() launches, {winding.launches} "
          "winding(); host pack_windows (to the card included): "
          + ", ".join(f"{name} {pack_s[f'{name}_windows']:.3f} s" for name in win_batches))

    # --- tile coverage path, once ------------------------------------------
    reset_counts()
    cov_outputs = {}
    for name, (batch, grids, size) in atlases.items():
        before = coverage.launches
        cov = engine.coverage_batch(batch.segments, *grid_anchors(grids), height=size,
                                    width=size, samples=SAMPLES)
        cov_outputs[name] = (cov, engine.coverage_to_gray(cov))
        torch.cuda.synchronize()
        check(coverage.launches > before, f"{name} did not launch the coverage kernel")
    coverage_launches = coverage.launches
    print(f"coverage path: {coverage_launches} coverage kernel launches, "
          f"{winding.launches} winding")

    # --- SDF atlas path, once -------------------------------------------------
    fonts = {name: font_path for name, font_path, _, _ in ATLASES}
    sdf_atlases = {}
    for name, source, size in SDF_ATLASES:
        batch = atlases[source][0]
        upem = Font.open(fonts[source]).info.units_per_em
        grids = [RasterGrid.fixed_tile(tuple(box), size, upem, size)
                 for box in np.asarray(batch.boxes)]
        sdf_atlases[name] = (batch, grids, size)
    reset_counts()
    sdf_outputs = {}
    for name, (batch, grids, size) in sdf_atlases.items():
        before = sdf.launches
        out = engine.sdf_batch(batch.segments, *grid_anchors(grids), height=size, width=size)
        sdf_outputs[name] = (out, engine.sdf_to_u8(out))
        torch.cuda.synchronize()
        check(sdf.launches > before, f"{name} did not launch the SDF kernel")
    sdf_launches, sdf_winding_launches = sdf.launches, winding.launches
    print(f"SDF path: {sdf_launches} SDF kernel launches, {sdf_winding_launches} winding, "
          f"{coverage.launches} coverage")

    # --- Loop-Blinn atlas path (BASELINE config 3), once ----------------------
    lb_tris, lb_classes, lb_grids, pack_s["ascii128_meshes"] = load_meshes(
        DEJAVU, LB_CHARS, LB_SIZE)
    print(f"ascii128: triangles {list(lb_tris.shape)} "
          f"({int((lb_classes != loopblinn_ref.CLASS_PAD).sum())} live), host "
          f"triangulation and padding {pack_s['ascii128_meshes']:.3f} s")
    lb_args = triangles_to_device(lb_tris, lb_classes, lb_grids, dev)
    g_mesh = TriangulatedGlyph.from_glyph(font.get_glyph("g")[0])
    g_grid = RasterGrid.for_glyph_box(pack_glyph(font.get_glyph("g")[0]).box, LB_SIZE,
                                      font.info.units_per_em)
    reset_counts()
    lb_out = loopblinn.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE)
    torch.cuda.synchronize()
    check(loopblinn.launches == 1, "the Loop-Blinn atlas did not launch the kernel once")
    g_fill = loopblinn.loopblinn_fill(g_mesh, g_grid)
    check(loopblinn.launches == 2, "loopblinn_fill did not launch the kernel")
    lb_launches = loopblinn.launches
    print(f"Loop-Blinn path: {lb_launches} Loop-Blinn kernel launches, "
          f"{winding.launches} winding, {coverage.launches} coverage, {sdf.launches} SDF")

    # --- direct page path (BASELINE config 5's session, the 4K stress page) --
    upem = font.info.units_per_em
    views4k = stress_views(upem)
    sess5, pack_s["config5_layout"] = open_session(font, CONFIG5_TEXT, CONFIG5_SIZE, dev)
    page4k, pack_s["page4k_layout"] = load_page(font, STRESS_TEXT, STRESS_SIZE, views4k[0], dev)
    reset_counts()
    frames5, views5 = run_events(sess5, CONFIG5_EVENTS)
    stats5 = sess5.stats()  # config 5's frames as the user sees them
    band5 = sess5.renderer.render_direct(views5[0], band=PAGE_BAND)
    sess5.key("d")
    gray5 = sess5.display_frame()      # the debug gray at the last view, opaque
    sess5.key("d")
    sess5.key("t")
    clear5 = sess5.display_frame()     # the fill again, transparent
    frames4k = [page4k.render_direct(view) for view in views4k]
    torch.cuda.synchronize()
    page_launches = page.launches
    check(page_launches == len(views5) + 3 + len(views4k),
          f"the page path launched the page kernel {page_launches} times")
    check(page.msaa_launches == 0 and winding.launches == 0,
          "the page path launched the MSAA or the winding kernel")
    print(f"page path: {page_launches} page kernel launches ({len(views5)} config5 session "
          f"frames, a band, the d and t frames, {len(views4k)} 4K frames), {winding.launches} "
          f"winding, {page.msaa_launches} MSAA; host layout and compaction: config5 "
          f"{pack_s['config5_layout']:.3f} s, page4k {pack_s['page4k_layout']:.3f} s; "
          f"config5 session stats {json.dumps(stats5)}")

    # --- page MSAA path (the session's m key, the 4K stress page) -----------
    sess5m, _ = open_session(font, CONFIG5_TEXT, CONFIG5_SIZE, dev)
    sessn, pack_s["narrow_layout"] = open_session(font, NARROW_TEXT, NARROW_SIZE, dev)
    reset_counts()
    sess5m.key("m")
    msaa5, views5m = run_events(sess5m, CONFIG5_EVENTS)
    sessn.key("m")
    msaan, viewsn = run_events(sessn, NARROW_EVENTS)
    msaa4k = [page4k.render_direct(view, msaa=True) for view in views4k]
    torch.cuda.synchronize()
    msaa_launches = page.msaa_launches
    check(msaa_launches == len(views5m) + len(viewsn) + len(views4k),
          f"the MSAA path launched the MSAA kernel {msaa_launches} times")
    check(page.launches == 0 and winding.launches == 0,
          "the MSAA path launched the single-sample page kernel or the winding kernel")
    check(views5m == views5, "the MSAA session's views differ from config 5's")
    stats5m, statsn = sess5m.stats(), sessn.stats()
    print(f"MSAA path: {msaa_launches} MSAA kernel launches ({len(views5m)} config5 session "
          f"frames, {len(viewsn)} narrow session frames, {len(views4k)} 4K frames), "
          f"{page.launches} single-sample page, {winding.launches} winding; config5 session "
          f"stats {json.dumps(stats5m)}; narrow session stats {json.dumps(statsn)}")

    # --- checks ------------------------------------------------------------
    record = {"winding": {}, "coverage": {}, "sdf": {}, "loopblinn": {}, "page": {},
              "page_msaa": {}, "winding_windows": {}}
    max_err = {"winding": 0, "coverage": 0.0, "sdf": 0.0, "loopblinn": 0, "page": 0,
               "page_msaa": 0, "winding_windows": 0}
    for name, (batch, grids, size) in atlases.items():
        args = packed_to_device(batch, grids, dev)
        b = len(grids)
        out = outputs[name]
        ref = winding_ref.winding_batch(*args, height=size, width=size)
        check(out.shape == ref.shape == (b, size, size), f"{name} winding shape")
        diff = int((out != ref).sum())
        max_err["winding"] = max(max_err["winding"], int((out - ref).abs().max()))
        check(diff == 0, f"{name}: {diff} pixels differ from winding_ref")

        out_host = out.cpu().numpy()
        sampled = range(0, b, ORACLE_STRIDE)
        mism = 0
        for i in sampled:
            xs, ys = grids[i].sample_coords()
            wo = oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None],
                                   contract=False)
            mism += int((wo != out_host[i]).sum())
        check(mism == 0, f"{name}: {mism} pixels differ from the oracle")
        print(f"{name} winding: 0 of {out.numel()} pixels differ from winding_ref; "
              f"0 of {len(sampled) * size * size} differ from the oracle "
              f"({len(sampled)} glyphs); inked {int((out != 0).sum())}")

        cov, gray = cov_outputs[name]
        cref = coverage_ref.coverage_batch(*args, height=size, width=size, samples=SAMPLES)
        check(cov.shape == cref.shape == (b, size, size) and cov.dtype == torch.float32,
              f"{name} coverage shape")
        check(bool(torch.isfinite(cov).all()) and float(cov.min()) >= 0
              and float(cov.max()) <= 1, f"{name} coverage outside [0, 1]")
        diff = int((cov != cref).sum())
        max_err["coverage"] = max(max_err["coverage"], float((cov - cref).abs().max()))
        check(diff == 0, f"{name}: {diff} coverage pixels differ from coverage_ref")
        check(torch.equal(gray, coverage_ref.coverage_to_gray(cref)), f"{name} gray")
        cov_host = cov.cpu().numpy()
        sampled = range(0, b, COVERAGE_ORACLE_STRIDE)
        mism = sum(int((coverage_oracle(batch.segments[i], grids[i], SAMPLES)
                        != cov_host[i]).sum()) for i in sampled)
        check(mism == 0, f"{name}: {mism} coverage pixels differ from the oracle")
        print(f"{name} coverage k={SAMPLES}: 0 of {cov.numel()} pixels differ from "
              f"coverage_ref; 0 of {len(sampled) * size * size} differ from the oracle "
              f"({len(sampled)} glyphs); partial pixels "
              f"{int(((cov > 0) & (cov < 1)).sum())}")

        kernels = {
            "winding": (
                lambda: winding.winding_batch(*args, height=size, width=size),
                lambda: winding_ref.winding_batch(*args, height=size, width=size),
                bound(batch, args, out, row_offsets=[0.0], columns=1, samples_per_pixel=1),
            ),
            "coverage": (
                lambda: coverage.coverage_batch(*args, height=size, width=size,
                                                samples=SAMPLES),
                lambda: coverage_ref.coverage_batch(*args, height=size, width=size,
                                                    samples=SAMPLES),
                # the k sub-row offsets; ox varies fastest in sample_offsets
                bound(batch, args, cov,
                      row_offsets=coverage_ref.sample_offsets(SAMPLES)[::SAMPLES, 1],
                      columns=SAMPLES, samples_per_pixel=SAMPLES * SAMPLES),
            ),
        }
        for kname, (kernel, plain, (b_ms, bound_by, ops, crossings)) in kernels.items():
            call_ms = cuda_ms(kernel, inner=10)
            kernel_ms = graph_ms(kernel)
            plain_ms = cuda_ms(plain, inner=1)
            record[kname][name] = dict(ms=kernel_ms, plain_ms=plain_ms, call_ms=call_ms,
                                       bound_ms=b_ms, bound_by=bound_by, bound_ops=ops,
                                       crossings=crossings)
            print(f"{name} {kname}: kernel {kernel_ms:.4f} ms on the device "
                  f"({b / kernel_ms * 1e3:.0f} glyphs/s), {call_ms:.4f} ms per wrapper "
                  f"call; bound {b_ms:.4f} ms ({bound_by}; {ops} FP32 ops, {crossings} "
                  f"crossings); plain version "
                  f"{plain_ms:.3f} ms ({b / plain_ms * 1e3:.0f} glyphs/s)")

    for name, (segs, min_x, max_y, scale, size) in win_batches.items():
        wins, out = windows[name], win_outputs[name]
        b = len(segs)
        seg_d, min_x_d, max_y_d, scale = to_device(segs, min_x, max_y, scale, dev)
        wargs = (wins.segments_win, wins.counts, min_x_d, max_y_d, scale)
        wkw = dict(height=size, width=size, win_rows=wins.win_rows)
        ref = winding_ref.winding_windows_batch(*wargs, **wkw)
        check(out.shape == ref.shape == (b, size, size) and out.dtype == torch.int32,
              f"{name} windowed shape")
        diff = int((out != ref).sum())
        max_err["winding_windows"] = max(max_err["winding_windows"],
                                         int((out - ref).abs().max()))
        check(diff == 0, f"{name}: {diff} pixels differ from the plain windowed version")
        full = winding.winding_batch(seg_d, min_x_d, max_y_d, scale, height=size, width=size)
        diff = int((out != full).sum())
        check(diff == 0, f"{name}: {diff} pixels differ from winding.cu")
        out_host = out.cpu().numpy()
        sampled = range(0, b, WINDOW_ORACLE_STRIDE)
        mism = 0
        for i in sampled:
            xs = (min_x[i] + np.arange(size)).astype(np.float32) / np.float32(scale)
            ys = (max_y[i] - np.arange(size)).astype(np.float32) / np.float32(scale)
            wo = oracle.winding_at(segs[i], xs[None, :], ys[:, None], contract=False)
            mism += int((wo != out_host[i]).sum())
        check(mism == 0, f"{name}: {mism} windowed pixels differ from the oracle")

        counts = wins.counts.cpu().numpy()
        rows = [min(wins.win_rows, size - w * wins.win_rows) for w in range(wins.n_windows)]
        pairs = int((counts * np.array(rows)).sum())
        live = int((np.asarray(segs) != 0).any(axis=(2, 3)).sum())
        nbytes = window_bytes(counts, size, size)
        ops, crossings = window_work(wins.segments_win.cpu().numpy(), counts, max_y, scale,
                                     **wkw)
        b_ms, bound_by = bound_ms(nbytes, ops)

        def kernel():
            return winding.winding_windows_batch(*wargs, **wkw)

        kernel_ms = graph_ms(kernel)
        call_ms = cuda_ms(kernel, inner=10)
        engine_ms = cuda_ms(lambda: engine.winding_batch(
            segs, min_x, max_y, scale, height=size, width=size, windows=wins), inner=10)
        full_ms = graph_ms(lambda: winding.winding_batch(seg_d, min_x_d, max_y_d, scale,
                                                         height=size, width=size))
        plain_ms = cuda_ms(lambda: winding_ref.winding_windows_batch(*wargs, **wkw), inner=1,
                           reps=5, warmup=1)
        record["winding_windows"][name] = dict(
            ms=kernel_ms, plain_ms=plain_ms, call_ms=call_ms, engine_call_ms=engine_ms,
            bound_ms=b_ms, bound_by=bound_by, bound_bytes=nbytes, bound_ops=ops,
            crossings=crossings, win_rows=wins.win_rows, n_windows=wins.n_windows, cap=wins.cap,
            copies=int(counts.sum()), live_segments=live, pairs=pairs,
            winding_cu_pairs=live * size, winding_cu_ms=full_ms,
            host_pack_windows_s=pack_s[f"{name}_windows"])
        print(f"{name} windowed {size}x{size} ({wins.win_rows}-row windows, cap {wins.cap}): 0 "
              f"of {out.numel()} pixels differ from the plain version and from winding.cu; 0 of "
              f"{len(sampled) * size * size} differ from the oracle ({len(sampled)} glyphs); "
              f"{int(counts.sum())} copies of {live} live segments; (segment, row) pairs "
              f"{pairs}, {pairs / (live * size):.3f} of winding.cu's {live * size}")
        print(f"{name} winding_windows: kernel {kernel_ms:.4f} ms on the device "
              f"({b / kernel_ms * 1e3:.0f} glyphs/s), {call_ms:.4f} ms per wrapper call, "
              f"{engine_ms:.4f} ms per engine call; winding.cu on the same batch "
              f"{full_ms:.4f} ms ({kernel_ms / full_ms:.2f}x); bound {b_ms:.5f} ms ({bound_by}; "
              f"{nbytes} B, {ops} FP32 ops, {crossings} crossings); plain version "
              f"{plain_ms:.3f} ms")

    for name, (batch, grids, size) in sdf_atlases.items():
        args = packed_to_device(batch, grids, dev)
        b = len(grids)
        out, u8 = sdf_outputs[name]
        t0 = time.perf_counter()
        ref = sdf_ref.sdf_batch(*args, height=size, width=size)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        check(out.shape == ref.shape == (b, size, size) and out.dtype == torch.float32,
              f"{name} SDF shape")
        check(bool(torch.isfinite(out).all()) and float(out.abs().max()) <= sdf_ref.SPREAD_PX,
              f"{name} SDF not finite or outside the spread")
        diff = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
        max_err["sdf"] = max(max_err["sdf"], float((out - ref).abs().max()))
        check(diff == 0, f"{name}: {diff} SDF pixels differ from sdf_ref (bit patterns)")
        check(torch.equal(u8, sdf_ref.sdf_to_u8(ref)), f"{name} sdf_to_u8")
        inside = ~torch.signbit(out).cpu().numpy()
        sampled = range(0, b, SDF_ORACLE_STRIDE)
        mism = 0
        for i in sampled:
            xs, ys = grids[i].sample_coords()
            wo = oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None], contract=False)
            mism += int(((wo != 0) != inside[i]).sum())
        check(mism == 0, f"{name}: {mism} SDF signs differ from the oracle")
        print(f"{name} SDF {size}x{size}: 0 of {out.numel()} pixels differ from sdf_ref "
              f"(int32 bit patterns; sdf_ref took {ref_s:.2f} s); sdf_to_u8 equal; 0 of "
              f"{len(sampled) * size * size} signs differ from the oracle ({len(sampled)} "
              f"glyphs); within the band {int((out.abs() < sdf_ref.SPREAD_PX).sum())}")

        w = winding.winding_batch(*args, height=size, width=size)
        b_ms, bound_by, ops, pairs = sdf_bound(args, out)
        kernel_ms = graph_ms(
            lambda: sdf.sdf_from_winding(*args, w, height=size, width=size))
        call_ms = cuda_ms(lambda: sdf.sdf_batch(*args, height=size, width=size), inner=10)
        plain_ms = cuda_ms(
            lambda: sdf_ref.sdf_from_winding(*args, w, height=size, width=size),
            inner=1, reps=3, warmup=1)
        record["sdf"][name] = dict(ms=kernel_ms, plain_ms=plain_ms, call_ms=call_ms,
                                   bound_ms=b_ms, bound_by=bound_by, bound_ops=ops,
                                   needed_pairs=pairs)
        print(f"{name} sdf: kernel {kernel_ms:.4f} ms on the device "
              f"({b / kernel_ms * 1e3:.0f} glyphs/s, {pairs} needed pairs), {call_ms:.4f} ms "
              f"per wrapper call (winding + distance); bound {b_ms:.4f} ms ({bound_by}; "
              f"{ops} FP32 ops); plain version {plain_ms:.3f} ms")

    b = len(lb_grids)
    lb_ref = loopblinn_ref.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE)
    check(lb_out.shape == lb_ref.shape == (b, LB_SIZE, LB_SIZE) and lb_out.dtype == torch.bool,
          "Loop-Blinn atlas shape")
    diff = int((lb_out != lb_ref).sum())
    max_err["loopblinn"] = int((lb_out.int() - lb_ref.int()).abs().max())
    check(diff == 0, f"ascii128: {diff} Loop-Blinn pixels differ from loopblinn_ref")
    t0 = time.perf_counter()
    lb_cpu = loopblinn_ref.loopblinn_batch(
        *triangles_to_device(lb_tris, lb_classes, lb_grids, "cpu"),
        height=LB_SIZE, width=LB_SIZE)
    cpu_s = time.perf_counter() - t0
    diff = int((lb_out.cpu() != lb_cpu).sum())
    check(diff == 0, f"ascii128: {diff} Loop-Blinn pixels differ from loopblinn_ref on the CPU")
    g_cpu = loopblinn.loopblinn_fill(g_mesh, g_grid, device="cpu")
    check(g_fill.shape == (g_grid.height, g_grid.width) and np.array_equal(g_fill, g_cpu),
          "loopblinn_fill('g') differs from the plain version")
    mism = 0
    for ch in LB_WINDING_CHARS:
        glyph = font.get_glyph(ch)[0]
        cgrid = RasterGrid.for_glyph_box(pack_glyph(glyph).box, LB_WINDING_SIZE,
                                         font.info.units_per_em)
        mesh = TriangulatedGlyph.from_glyph(glyph)
        margs = triangles_to_device(*loopblinn.pack_meshes([mesh]), [cgrid], dev)
        fill = loopblinn.loopblinn_batch(*margs, height=cgrid.height, width=cgrid.width,
                                         sample_offset=LB_WINDING_OFFSET)
        seg = torch.from_numpy(glyph_segments(glyph))[None].to(dev)
        w = winding.winding_batch(seg, *margs[2:], height=cgrid.height, width=cgrid.width,
                                  sample_offset=LB_WINDING_OFFSET)
        mism += int((fill != (w != 0)).sum())
    check(mism == 0, f"{mism} Loop-Blinn pixels differ from the winding fill at tie-free offsets")
    print(f"ascii128 Loop-Blinn: 0 of {lb_out.numel()} pixels differ from loopblinn_ref on "
          f"the card, 0 from it on the CPU (took {cpu_s:.2f} s); 'g' fill {g_grid.height}x"
          f"{g_grid.width} equals the plain version; {LB_WINDING_CHARS!r} @"
          f"{LB_WINDING_SIZE} at offset (1/3, 1/3) equal the winding fill; "
          f"covered {int(lb_out.sum())}")

    def lb_kernel():
        return loopblinn.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE)

    nbytes = loopblinn_bytes(lb_classes, LB_SIZE, LB_SIZE)
    ops, pairs = loopblinn_work(*lb_args, height=LB_SIZE, width=LB_SIZE)
    b_ms, bound_by = bound_ms(nbytes, ops)
    kernel_ms = graph_ms(lb_kernel)
    call_ms = cuda_ms(lb_kernel, inner=10)
    # the same launch with no triangles: the blocks, the anchors and the output
    no_tris = (lb_args[0][:, :0].contiguous(), lb_args[1][:, :0].contiguous(), *lb_args[2:])
    empty_ms = graph_ms(
        lambda: loopblinn.loopblinn_batch(*no_tris, height=LB_SIZE, width=LB_SIZE))
    plain_ms = cuda_ms(
        lambda: loopblinn_ref.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE),
        inner=1, reps=5, warmup=1)
    record["loopblinn"]["ascii128"] = dict(
        ms=kernel_ms, plain_ms=plain_ms, call_ms=call_ms, no_triangles_ms=empty_ms,
        bound_ms=b_ms, bound_by=bound_by, bound_bytes=nbytes, bound_ops=ops,
        inside_pairs=pairs, plain_cpu_s=cpu_s)
    print(f"ascii128 loopblinn: kernel {kernel_ms:.4f} ms on the device "
          f"({b / kernel_ms * 1e3:.0f} glyphs/s; {empty_ms:.4f} ms with no triangles), "
          f"{call_ms:.4f} ms per wrapper call; bound {b_ms:.5f} ms ({bound_by}; {nbytes} B, "
          f"{ops} FP32 ops, {pairs} inside pairs); plain version {plain_ms:.3f} ms")

    frames5 = [torch.from_numpy(f).to(dev) for f in frames5]  # the session's host frames
    for name, renderer, views, frames in (("config5", sess5.renderer, views5, frames5),
                                          ("page4k", page4k, views4k, frames4k)):
        h, w = renderer.height, renderer.width
        per_frame = []
        ref_s = 0.0
        for k, (view, frame) in enumerate(zip(views, frames)):
            check(frame.shape == (h, w) and frame.dtype == torch.uint8, f"{name} frame shape")
            inputs = renderer.page_inputs(view)
            t0 = time.perf_counter()
            want = page_ref.direct_page(*inputs, page_h=h, page_w=w, mode="winding")
            torch.cuda.synchronize()
            ref_s += time.perf_counter() - t0
            diff = int((frame != page_ref.finish(want, "fill")).sum())
            check(diff == 0, f"{name} frame {k}: {diff} pixels differ from page_ref")
            got = page.direct_page(*inputs, page_h=h, page_w=w, mode="winding")
            max_err["page"] = max(max_err["page"], int((got - want).abs().max()))
            check(torch.equal(got, want), f"{name} frame {k}: the int32 page differs from "
                  "page_ref's")
            # the winding of every pair: the same page where no root strays
            every_pair = int((got != winding_page(inputs, h, w)).sum())
            if name == "config5" and k == 0:  # ViewTransform.init: the transform is exact
                check(every_pair == 0, f"config5 first frame: {every_pair} pixels differ from "
                      "the winding kernel at batch 1")
            q = page_ref.transform_segments(*inputs).reshape(-1, 6)
            ops, needed, crossings = page_work(*inputs, page_h=h, page_w=w)
            nbytes = page_bytes(len(inputs[0]), len(inputs[2]), h, w, "fill")
            b_ms, bound_by = bound_ms(nbytes, ops)
            per_frame.append(dict(
                ms=graph_ms(lambda: page.direct_page(*inputs, page_h=h, page_w=w), calls=10),
                bound_ms=b_ms, bound_by=bound_by, bound_ops=ops,
                visited_pairs=int(page_ref.page_rows(q, h - 1, h, w).sum()),
                needed_pairs=needed, crossings=crossings, inked=int((frame != 0).sum()),
                every_pair_differs=every_pair))
        print(f"{name}: {len(frames)} frames {h}x{w}: 0 pixels differ from page_ref (int32 and "
              f"fill; page_ref took {ref_s:.2f} s in all)"
              + ("; the first frame equals the winding kernel at batch 1" if name == "config5"
                 else "") + "; per frame:")
        for k, f in enumerate(per_frame):
            print(f"  {name} frame {k}: {f['ms']:.4f} ms, bound {f['bound_ms']:.5f} ms "
                  f"({f['bound_by']}), visited {f['visited_pairs']}, crossings "
                  f"{f['crossings']}, inked {f['inked']}, every pair differs "
                  f"{f['every_pair_differs']}")

        inputs = renderer.page_inputs(views[0])
        if name == "config5":
            ref = page_ref.direct_page(*inputs, page_h=h, page_w=w, mode="winding")
            y0, rows = PAGE_BAND
            check(torch.equal(band5, frames[0][y0 : y0 + rows]),
                  "config5 band differs from the frame's rows")
            check(torch.equal(band5, page_ref.direct_page(*inputs, y0, page_h=h, page_w=w,
                                                          out_h=rows)),
                  "config5 band differs from page_ref's")
            last = page_ref.direct_page(*renderer.page_inputs(views[-1]), page_h=h, page_w=w,
                                        mode="gray").cpu().numpy()
            check(gray5.shape == (h, w, 4) and (gray5[..., 3] == 255).all()
                  and all(np.array_equal(gray5[..., c], last) for c in range(3)),
                  "config5 d frame: not page_ref's debug gray, opaque")
            fill_last = frames[-1].cpu().numpy()
            check(all(np.array_equal(clear5[..., c], fill_last) for c in range(4)),
                  "config5 t frame: not the last fill with alpha = coverage")
            q = page_ref.transform_segments(*inputs).cpu().numpy()
            rows_o = np.arange(0, h, PAGE_ORACLE_STRIDE)
            t1 = time.perf_counter()
            wo = oracle_rows(q, w, [(np.float32(h - 1 - r), 0.0) for r in rows_o])
            oracle_s = time.perf_counter() - t1
            mism = int((wo != ref[rows_o].cpu().numpy()).sum())
            check(mism == 0, f"config5: {mism} pixels differ from the oracle")
            print(f"config5: the band {PAGE_BAND} equals the frame's rows and page_ref's band; "
                  f"the d frame is page_ref's debug gray at the last view, opaque; the t frame "
                  f"is the last fill with alpha = coverage; 0 of {len(rows_o) * w} pixels on "
                  f"every {PAGE_ORACLE_STRIDE}th row of the first frame differ from the oracle "
                  f"(took {oracle_s:.1f} s)")
        else:
            y0, rows = STRESS_REF_BAND
            ref = page_ref.direct_page(*inputs, y0, page_h=h, page_w=w, out_h=rows,
                                       mode="winding")
            got = page.direct_page(*inputs, y0, page_h=h, page_w=w, out_h=rows, mode="winding")
            check(torch.equal(got, ref), "page4k band differs from page_ref's")
            print(f"page4k: the band [{y0}, {y0 + rows}) equals page_ref's")

        first = per_frame[0]
        call_ms = cuda_ms(lambda: renderer.render_direct(views[0]), inner=10)
        flat = page_ref.transform_segments(*inputs)[None].contiguous()
        anchors = (torch.zeros(1, dtype=torch.int32, device=dev),
                   torch.full((1,), h - 1, dtype=torch.int32, device=dev))
        winding_ms = graph_ms(
            lambda: winding.winding_batch(flat, *anchors, 1.0, height=h, width=w), calls=5)
        d2h_ms = cuda_ms(lambda: frames[0].cpu(), inner=1)
        plain_ms = cuda_ms(lambda: page_ref.direct_page(*inputs, page_h=h, page_w=w), inner=1,
                           reps=3, warmup=1)

        def mean(key):
            return statistics.fmean(f[key] for f in per_frame)

        # the frames' mean in the main keys: what the traffic costs a frame
        rec = dict(ms=mean("ms"), plain_ms=plain_ms, call_ms=call_ms,
                   bound_ms=mean("bound_ms"), bound_by=first["bound_by"],
                   frames=len(per_frame), bound_ops=mean("bound_ops"),
                   bound_bytes=page_bytes(len(inputs[0]), len(inputs[2]), h, w, "fill"),
                   segments=len(inputs[0]), instances=len(inputs[2]),
                   visited_pairs=mean("visited_pairs"), needed_pairs=mean("needed_pairs"),
                   all_pairs=len(inputs[0]) * h, crossings=mean("crossings"),
                   max_ms=max(f["ms"] for f in per_frame),
                   first_ms=first["ms"], first_bound_ms=first["bound_ms"],
                   first_visited_pairs=first["visited_pairs"], first_crossings=first["crossings"],
                   winding_cu_first_ms=winding_ms, frame_d2h_ms=d2h_ms,
                   host_layout_s=pack_s[f"{name}_layout"], plain_all_frames_s=ref_s,
                   inked_first=first["inked"], inked_min=min(f["inked"] for f in per_frame),
                   inked_max=max(f["inked"] for f in per_frame),
                   every_pair_differs_max=max(f["every_pair_differs"] for f in per_frame))
        if name == "page4k":
            y0, rows = STRESS_REF_BAND
            rec["band_ms"] = graph_ms(
                lambda: page.direct_page(*inputs, y0, page_h=h, page_w=w, out_h=rows))
        if name == "config5":  # the user's frame: the session's, the page to the host included
            rec.update(session_frame_ms=stats5["mean_ms"], session_p99_ms=stats5["p99_ms"],
                       session_compute_ms=stats5["compute_ms"])
        record["page"][name] = rec
        print(f"{name} page: S {len(inputs[0])} segments, {len(inputs[2])} instances, "
              f"{len(per_frame)} frames; mean per frame: kernel {rec['ms']:.4f} ms on the "
              f"device (max {rec['max_ms']:.4f}), bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of the kernel's time), visited pairs "
              f"{rec['visited_pairs']:.0f}, needed {rec['needed_pairs']:.0f}, crossings "
              f"{rec['crossings']:.0f}; first frame: kernel {first['ms']:.4f} ms, bound "
              f"{first['bound_ms']:.5f} ms, visited {first['visited_pairs']}, render_direct "
              f"{call_ms:.4f} ms per call, winding.cu on the same page {winding_ms:.4f} ms, "
              f"frame to host {d2h_ms:.4f} ms, plain version {plain_ms:.3f} ms")

    lattice = [(ox, oy) for oy, oxs in page_ref.msaa_lattice() for ox in oxs]
    for name, renderer, views, frames, stats in (
            ("config5", sess5m.renderer, views5m, msaa5, stats5m),
            ("narrow", sessn.renderer, viewsn, msaan, statsn),
            ("page4k", page4k, views4k, msaa4k, None)):
        h, w = renderer.height, renderer.width
        frames = [torch.as_tensor(f).to(dev) for f in frames]  # the sessions' are host arrays
        per_frame = []
        ref_s = 0.0
        for k, (view, frame) in enumerate(zip(views, frames)):
            check(frame.shape == (h, w) and frame.dtype == torch.uint8, f"{name} MSAA shape")
            inputs = renderer.page_inputs(view)
            t0 = time.perf_counter()
            want = page_ref.direct_page_msaa(*inputs, page_h=h, page_w=w)
            torch.cuda.synchronize()
            ref_s += time.perf_counter() - t0
            diff = int((frame != want).sum())
            max_err["page_msaa"] = max(max_err["page_msaa"],
                                       int((frame.int() - want.int()).abs().max()))
            check(diff == 0, f"{name} MSAA frame {k}: {diff} pixels differ from page_ref")
            check(set(torch.unique(frame).tolist()) <= {0, 63, 127, 191, 255},
                  f"{name} MSAA frame {k}: a value off the 2 x 2 lattice")
            q = page_ref.transform_segments(*inputs).reshape(-1, 6)
            ops, needed, crossings = page_msaa_work(*inputs, page_h=h, page_w=w)
            nbytes = page_msaa_bytes(len(inputs[0]), len(inputs[2]), h, w)
            b_ms, bound_by = bound_ms(nbytes, ops)
            per_frame.append(dict(
                ms=graph_ms(lambda: page.direct_page_msaa(*inputs, page_h=h, page_w=w),
                            calls=10),
                bound_ms=b_ms, bound_by=bound_by, bound_ops=ops, needed_pairs=needed,
                crossings=crossings,
                visited_pairs=sum(int(page_ref.page_rows(q, h - 1, h, w, oy, oxs).sum())
                                  for oy, oxs in page_ref.msaa_lattice()),
                partial=int(((frame > 0) & (frame < 255)).sum())))
        inputs = renderer.page_inputs(views[0])
        note = ""
        if name != "page4k":  # the first view: the transform is exact, no root strays
            passes = [winding_page(inputs, h, w, off) for off in lattice]
            diff = int((frames[0] != msaa_from_windings(passes)).sum())
            check(diff == 0, f"{name} first MSAA frame: {diff} pixels differ from four "
                  "winding-kernel passes")
            note = "; the first frame equals four winding-kernel passes at the sample offsets"
        if name == "config5":
            q = page_ref.transform_segments(*inputs).cpu().numpy()
            rows_o = np.array(MSAA_ORACLE_ROWS)
            t1 = time.perf_counter()
            wo = oracle_rows(q, w, [(np.float32(h - 1 - r) + np.float32(oy), ox)
                                    for ox, oy in lattice for r in rows_o])
            wo = wo.reshape(len(lattice), len(rows_o), w)
            oracle_s = time.perf_counter() - t1
            mism = int((msaa_from_windings(wo) != frames[0][rows_o].cpu().numpy()).sum())
            check(mism == 0, f"config5 first MSAA frame: {mism} pixels differ from the oracle")
            note += (f"; 0 of {len(rows_o) * w} pixels on rows {rows_o.tolist()} differ from the "
                     f"oracle at the four offsets (took {oracle_s:.1f} s)")
        print(f"{name} MSAA: {len(frames)} frames {h}x{w}: 0 pixels differ from page_ref "
              f"(page_ref took {ref_s:.2f} s in all){note}; per frame:")
        for k, f in enumerate(per_frame):
            print(f"  {name} MSAA frame {k}: {f['ms']:.4f} ms, bound {f['bound_ms']:.5f} ms "
                  f"({f['bound_by']}), visited {f['visited_pairs']}, needed "
                  f"{f['needed_pairs']}, crossings {f['crossings']}, partial {f['partial']}")

        first = per_frame[0]
        call_ms = cuda_ms(lambda: renderer.render_direct(views[0], msaa=True), inner=10)
        four_ms = graph_ms(lambda: [page.direct_page(*inputs, page_h=h, page_w=w,
                                                     sample_offset=off) for off in lattice],
                           calls=5)
        plain_ms = cuda_ms(lambda: page_ref.direct_page_msaa(*inputs, page_h=h, page_w=w),
                           inner=1, reps=3, warmup=1)

        def mean(key):
            return statistics.fmean(f[key] for f in per_frame)

        rec = dict(ms=mean("ms"), plain_ms=plain_ms, call_ms=call_ms,
                   bound_ms=mean("bound_ms"), bound_by=first["bound_by"],
                   frames=len(per_frame), bound_ops=mean("bound_ops"),
                   bound_bytes=page_msaa_bytes(len(inputs[0]), len(inputs[2]), h, w),
                   segments=len(inputs[0]), visited_pairs=mean("visited_pairs"),
                   needed_pairs=mean("needed_pairs"), crossings=mean("crossings"),
                   max_ms=max(f["ms"] for f in per_frame), first_ms=first["ms"],
                   first_bound_ms=first["bound_ms"], four_page_passes_first_ms=four_ms,
                   plain_all_frames_s=ref_s)
        if stats is not None:  # the user's frame: the session's, the page to the host included
            rec.update(session_frame_ms=stats["mean_ms"], session_p99_ms=stats["p99_ms"],
                       session_compute_ms=stats["compute_ms"])
        record["page_msaa"][name] = rec
        single = record["page"].get(name, {}).get("ms")
        print(f"{name} MSAA page: S {len(inputs[0])} segments, {len(per_frame)} frames; mean "
              f"per frame: kernel {rec['ms']:.4f} ms on the device (max {rec['max_ms']:.4f}"
              + (f"; {rec['ms'] / single:.2f}x the single-sample page's {single:.4f}"
                 if single else "")
              + f"), bound {rec['bound_ms']:.5f} ms ({rec['bound_ms'] / rec['ms']:.1%} of the "
              f"kernel's time), visited pairs {rec['visited_pairs']:.0f}, needed "
              f"{rec['needed_pairs']:.0f}, crossings {rec['crossings']:.0f}; first frame: "
              f"kernel {first['ms']:.4f} ms, four single-sample page passes {four_ms:.4f} ms, "
              f"render_direct {call_ms:.4f} ms per call, plain version {plain_ms:.3f} ms"
              + (f"; session frame {stats['mean_ms']:.3f} ms (p99 {stats['p99_ms']:.3f}), "
                 f"render alone {stats['compute_ms']:.3f} ms" if stats else ""))

    want = np.where(oracle.winding_map(packed.segments, grid, contract=False) != 0,
                    255, 0).astype(np.uint8)
    check(decoded.shape == (grid.height, grid.width, 3), "quick start QOI shape")
    check(all(np.array_equal(decoded[:, :, c], want) for c in range(3)),
          "quick start QOI differs from the oracle fill")
    print(f"quick start: 'A' @256 {grid.height}x{grid.width} QOI round trip "
          "equals the oracle fill")

    ref_mask = (winding_ref.winding_batch(*example_args, height=128, width=640) != 0)
    check(mask.shape == (8, 128, 640) and bool(torch.isfinite(mask).all()),
          "entry() output shape or values")
    check(torch.equal(mask, ref_mask.to(torch.float32)), "entry() differs from winding_ref")
    print(f"entry(): [8, 128, 640] mask equals winding_ref, inked {int(mask.sum())}")

    # --- host baseline and the card ------------------------------------------
    batch, grids, _ = atlases["ascii256"]
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(2):
            xs, ys = grids[i].sample_coords()
            oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None])
        reps.append((time.perf_counter() - t0) / 2)
    print(f"host oracle @256: {1.0 / min(reps):.3f} glyphs/s (2 glyphs, best of 3)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])

    def entry_of(kname, replaces, launches, main_atlas="ascii256", source=None, **extra):
        main = record[kname][main_atlas]
        return {
            "name": kname, "route": "cuda",
            "source": source or f"fontrx_torch/csrc/{kname}.cu",
            "replaces": replaces, **extra, "launches": launches,
            "max_abs_err": max_err[kname],
            # the main atlas in the main keys, the other atlases beside them
            **main, "library_ms": None,
            **{f"{atlas}_{key}": value for atlas, rec in record[kname].items()
               if atlas != main_atlas for key, value in rec.items()},
        }

    print(json.dumps({"kernels": [
        entry_of("winding", "fontrx/kernels/winding_pallas_v2.py:628", winding_launches,
                 also_replaces="fontrx/kernels/winding_dense.py:297"),
        entry_of("coverage", "fontrx/kernels/coverage_pallas.py:211", coverage_launches,
                 samples=SAMPLES),
        entry_of("sdf", "fontrx/kernels/sdf_pallas.py:180", sdf_launches,
                 also_replaces="fontrx/kernels/sdf_pallas.py:605",
                 spread_px=sdf_ref.SPREAD_PX, winding_launches=sdf_winding_launches),
        entry_of("loopblinn", "fontrx/kernels/loopblinn.py:314", lb_launches,
                 main_atlas="ascii128"),
        entry_of("page", "fontrx/kernels/winding_page.py:267", page_launches,
                 main_atlas="config5"),
        entry_of("page_msaa", "fontrx/kernels/winding_page.py:537", msaa_launches,
                 main_atlas="config5", source="fontrx_torch/csrc/page.cu", samples=SAMPLES),
        entry_of("winding_windows", "fontrx/kernels/winding_dense.py:673", windows_launches,
                 main_atlas="cjk64", source="fontrx_torch/csrc/winding.cu"),
    ], "host_pack_s": pack_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
