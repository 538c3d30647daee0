"""Drive fontrx_torch's glyph fill, tile coverage, SDF atlas and Loop-Blinn
atlas paths once on one CUDA card, and check them.

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
  ``loopblinn.loopblinn_fill``.

It then checks every result: each kernel against its plain PyTorch version
on every pixel (the SDF as int32 bit patterns; the Loop-Blinn atlas also
against the plain version on the CPU), the atlases against the NumPy oracle
(``contract=False``; for the SDF, its sign) on sampled glyphs, the quick
start against the oracle's fill, and the Loop-Blinn fill against the
winding fill at tie-free sample offsets on the glyphs of the JAX package's
own test (``tests/test_geometry.py``), and
times each kernel and its plain version with CUDA events: the kernel both
replayed from a CUDA graph (its device time) and called through its wrapper
(what a caller waits for, host launch overhead included). Any failure raises
and exits non-zero. The last two lines are JSON: the kernels' record (each
kernel's times beside its bound, from ``fontrx_torch.bound``, and the host
pack times), then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fontrx_torch.bound import bound_ms, loopblinn_bytes, loopblinn_work, sdf_work, solve_work
from fontrx_torch.convert import grid_anchors, packed_to_device, triangles_to_device
from fontrx_torch.device import probe, require_cuda
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.entry import entry
from fontrx_torch.font.font import Font
from fontrx_torch.geometry import TriangulatedGlyph
from fontrx_torch.io import qoi
from fontrx_torch.kernels import (
    _build, coverage, coverage_ref, loopblinn, loopblinn_ref, oracle, sdf, sdf_ref, winding,
    winding_ref)
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import glyph_segments, pack_glyph

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
    winding.launches = coverage.launches = sdf.launches = loopblinn.launches = 0
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

    # --- tile coverage path, once ------------------------------------------
    winding.launches = coverage.launches = sdf.launches = loopblinn.launches = 0
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
    winding.launches = coverage.launches = sdf.launches = loopblinn.launches = 0
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
    winding.launches = coverage.launches = sdf.launches = loopblinn.launches = 0
    lb_out = loopblinn.loopblinn_batch(*lb_args, height=LB_SIZE, width=LB_SIZE)
    torch.cuda.synchronize()
    check(loopblinn.launches == 1, "the Loop-Blinn atlas did not launch the kernel once")
    g_fill = loopblinn.loopblinn_fill(g_mesh, g_grid)
    check(loopblinn.launches == 2, "loopblinn_fill did not launch the kernel")
    lb_launches = loopblinn.launches
    print(f"Loop-Blinn path: {lb_launches} Loop-Blinn kernel launches, "
          f"{winding.launches} winding, {coverage.launches} coverage, {sdf.launches} SDF")

    # --- checks ------------------------------------------------------------
    record = {"winding": {}, "coverage": {}, "sdf": {}, "loopblinn": {}}
    max_err = {"winding": 0, "coverage": 0.0, "sdf": 0.0, "loopblinn": 0}
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

    def entry_of(kname, replaces, launches, main_atlas="ascii256", **extra):
        main = record[kname][main_atlas]
        return {
            "name": kname, "route": "cuda", "source": f"fontrx_torch/csrc/{kname}.cu",
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
    ], "host_pack_s": pack_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
