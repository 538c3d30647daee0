"""Drive fontrx_torch's glyph fill path once on one CUDA card, and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA winding kernel from ``fontrx_torch/csrc`` into ``build/``,
then drives the main path through the entry points a user calls:

1. the 94 printable ASCII glyphs of DejaVu Sans at 256 px on 256 x 256
   tiles, through ``RasterEngine.winding_batch``;
2. the 1024 glyphs of ``tests/data/cjktest.ttf`` (200-330 segments each) at
   64 px on 64 x 64 tiles;
3. the README quick start on 'A' at 256 px: ``winding_glyph`` -> ``fill`` ->
   QOI encode -> decode;
4. ``fontrx_torch.entry.entry()``'s raster step on its example batch.

It then checks every result: the kernel against its plain PyTorch version
on every pixel, the atlases against the NumPy oracle (``contract=False``)
on every 13th glyph, and the quick start against the oracle's fill, and
times the kernel and the plain version with CUDA events: the kernel both
replayed from a CUDA graph (its device time) and called through its wrapper
(what a caller waits for, host launch overhead included). Any failure raises
and exits non-zero. The last two lines are JSON: the kernels' record, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import time

import numpy as np
import torch

from fontrx.font.font import Font
from fontrx.io import qoi
from fontrx.kernels import oracle
from fontrx.kernels.grid import RasterGrid
from fontrx.pack.segments import pack_glyph
from fontrx_torch.convert import grid_anchors, packed_to_device
from fontrx_torch.device import probe, require_cuda
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.entry import entry
from fontrx_torch.kernels import _build, winding, winding_ref

ROOT = pathlib.Path(__file__).resolve().parent
DEJAVU = ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf"
CJK = ROOT / "tests" / "data" / "cjktest.ttf"

# (name, font, chars, font size = tile size)
ATLASES = (
    ("ascii256", DEJAVU, list(range(33, 127)), 256),
    ("cjk64", CJK, [0x4E00 + i for i in range(1024)], 64),
)
ORACLE_STRIDE = 13  # oracle-checked glyphs: every 13th, as bench.py samples


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


def load_atlas(font_path, chars, size):
    font = Font.open(str(font_path))
    batch = pack_charset(font, chars)
    grids = [
        RasterGrid.fixed_tile(tuple(box), size, font.info.units_per_em, size)
        for box in np.asarray(batch.boxes)
    ]
    return batch, grids


def main() -> None:
    dev = require_cuda()
    print("toolchain:", json.dumps(probe()))
    t0 = time.perf_counter()
    lib = _build.library_path("winding")
    cached = lib.exists()
    _build.load("winding")
    print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s"
          + (" (already built)" if cached else ""))

    atlases = {}
    for name, font_path, chars, size in ATLASES:
        batch, grids = load_atlas(font_path, chars, size)
        atlases[name] = (batch, grids, size)
        print(f"{name}: segments {list(batch.segments.shape)}")

    # --- the main path, once, through the user-facing entry points -------
    engine = RasterEngine(device=dev)
    winding.launches = 0
    outputs = {}
    for name, (batch, grids, size) in atlases.items():
        before = winding.launches
        outputs[name] = engine.winding_batch(
            batch.segments, *grid_anchors(grids), height=size, width=size)
        torch.cuda.synchronize()
        check(winding.launches > before, f"{name} did not launch the kernel")

    font = Font.open(str(DEJAVU))
    glyph, _advance = font.get_glyph("A")
    packed = pack_glyph(glyph)
    grid = RasterGrid.for_glyph_box(packed.box, 256, font.info.units_per_em)
    before = winding.launches
    fill = engine.fill(engine.winding_glyph(packed.segments, grid)).cpu().numpy()
    rgb = np.repeat(fill[:, :, None], 3, axis=2)
    decoded = qoi.decode(qoi.encode_rgb(rgb))
    check(winding.launches > before, "quick start did not launch the kernel")

    before = winding.launches
    fn, example_args = entry()
    mask = fn(*example_args)
    torch.cuda.synchronize()
    check(winding.launches > before, "entry() did not launch the kernel")
    main_launches = winding.launches
    print(f"main path: {main_launches} kernel launches")

    # --- checks ------------------------------------------------------------
    max_abs_err = 0
    record = {}
    for name, (batch, grids, size) in atlases.items():
        out = outputs[name]
        args = packed_to_device(batch, grids, dev)
        ref = winding_ref.winding_batch(*args, height=size, width=size)
        check(out.shape == ref.shape == (len(grids), size, size), f"{name} shape")
        diff = int((out != ref).sum())
        err = int((out - ref).abs().max())
        max_abs_err = max(max_abs_err, err)
        check(diff == 0, f"{name}: {diff} pixels differ from winding_ref")

        out_host = out.cpu().numpy()
        sampled = range(0, len(grids), ORACLE_STRIDE)
        mism = 0
        for i in sampled:
            xs, ys = grids[i].sample_coords()
            wo = oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None],
                                   contract=False)
            mism += int((wo != out_host[i]).sum())
        check(mism == 0, f"{name}: {mism} pixels differ from the oracle")
        print(f"{name}: 0 of {out.numel()} pixels differ from winding_ref; "
              f"0 of {len(sampled) * size * size} differ from the oracle "
              f"({len(sampled)} glyphs); inked {int((out != 0).sum())}")

        def kernel():
            return winding.winding_batch(*args, height=size, width=size)

        call_ms = cuda_ms(kernel, inner=10)
        kernel_ms = graph_ms(kernel)
        plain_ms = cuda_ms(
            lambda: winding_ref.winding_batch(*args, height=size, width=size), inner=1)
        b = len(grids)
        print(f"{name}: kernel {kernel_ms:.4f} ms on the device ({b / kernel_ms * 1e3:.0f} "
              f"glyphs/s), {call_ms:.4f} ms per wrapper call; winding_ref "
              f"{plain_ms:.3f} ms ({b / plain_ms * 1e3:.0f} glyphs/s)")
        record[name] = (kernel_ms, plain_ms, call_ms)

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

    print(json.dumps({"kernels": [{
        "name": "winding",
        "route": "cuda",
        "source": winding.SOURCE,
        "replaces": "fontrx/kernels/winding_pallas_v2.py:131",
        "also_replaces": "fontrx/kernels/winding_dense.py:84",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": record["ascii256"][0],
        "plain_ms": record["ascii256"][1],
        "call_ms": record["ascii256"][2],
        "cjk64_ms": record["cjk64"][0],
        "cjk64_plain_ms": record["cjk64"][1],
        "cjk64_call_ms": record["cjk64"][2],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
