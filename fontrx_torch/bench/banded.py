"""The row-banded strip atlas against the per-glyph winding: the port of the
JAX package's probes ``tools/tpu_probes/tpu_banded.py``,
``tpu_dense_banded.py`` and ``tpu_cjk_banded.py``, and the caller of
``winding_banded()`` (K5 and K6, ``csrc/winding.cu``).

    python -m fontrx_torch.bench.banded              # on the card
    python -m fontrx_torch.bench.banded --device cpu # their plain versions

A strip holds ``R = 128 / size`` glyphs of a ``size`` px atlas, one a band of
``size`` rows, each at its own anchors. Four cases, each one strip launch
against one launch of ``winding()`` over the same glyphs, one glyph a map:

- **dejavu64**, **dejavu32**: the full-font bucket of ``tpu_banded.py`` and
  ``tpu_dense_banded.py``, every glyph of the vendored DejaVu Sans with 1 to
  ``BUCKET`` segments (6,022 of its 6,253), at 64 px (``R = 2``) and 32 px
  (``R = 4``) on ``size x size`` tiles (``RasterGrid.fixed_tile``), each
  glyph's segments x-sorted: the strips from ``build_banded(sort="x")``, the
  glyphs from ``pack_glyphs(capacity=BUCKET, sort="x")``;
- **synth64**, **synth32**: ``tpu_cjk_banded.py``'s regime, ``bench.cjk.
  make_batch(1000, 288)``, ``R`` consecutive glyphs an element, every glyph at
  ``min_x = 0``, ``max_y = size - 1``.

One JSON line a case: its glyphs, elements and live segments, the pixels
where the strips differ from the per-glyph maps (0, or the run fails), the
launches of each kernel, and on a card each kernel's device ms (CUDA-graph
replays) and wrapper ms beside its bound (``fontrx_torch.bound``) and the card's
name and power limit. On the CPU both kernels are their plain versions and
no time is taken.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from dataclasses import dataclass

import numpy as np
import torch

from fontrx_torch import bound
from fontrx_torch.bench import cjk
from fontrx_torch.bench.roofline import smi
from fontrx_torch.bench.timing import cuda_ms, graph_ms
from fontrx_torch.convert import grid_anchors
from fontrx_torch.font.font import Font
from fontrx_torch.kernels import winding
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import glyph_segments, pack_glyphs, xsort_segments

DEJAVU = pathlib.Path(__file__).resolve().parents[1] / "data" / "DejaVuSans.ttf"
BUCKET = 64          # the most segments of a bucket glyph (tpu_banded.py:64-68)
SIZES = (64, 32)     # px: R = 2 and 4 bands a strip
CJK_GLYPHS = 1000    # tpu_cjk_banded.py:28-29
CJK_SEGMENTS = 288


@dataclass(frozen=True)
class Case:
    """One A/B: the strips and the per-glyph batch of the same glyphs.

    ``strip``: float32 segments ``[B, S, 3, 2]``, int32 owners ``[B, S]``,
    int32 ``min_x``, ``max_y`` ``[R, B]``; ``glyph``: float32 segments
    ``[n, S', 3, 2]``, their live counts, int32 ``min_x``, ``max_y`` ``[n]``.
    """

    name: str
    size: int
    glyphs: int
    scale: np.float32
    strip: tuple
    glyph: tuple


def bucket(font: Font, limit: int | None = None) -> list:
    """The glyphs of ``font`` with 1 to ``BUCKET`` segments, in glyph order
    (the first ``limit`` of them)."""
    glyphs = []
    for index in range(font.num_glyphs):
        if limit is not None and len(glyphs) == limit:
            break
        g = font.load_glyph_safe(index)
        if 0 < g.num_segments <= BUCKET:
            glyphs.append(g)
    return glyphs


def build_banded(glyphs, grids, bands, sort=None):
    """``bands`` glyphs an element, in order: glyph ``i`` is band ``i %
    bands`` of element ``i // bands``, its segments (x-sorted with
    ``sort="x"``) after those of the bands before it. Returns ``(segments
    [B, cap, 3, 2], owners [B, cap], min_x [bands, B], max_y [bands, B],
    cap)``, ``cap`` the largest element's count rounded up to 8 (at least 8);
    padding is zero segments of band 0. ``tpu_banded.py:34-56``, with
    ``tpu_dense_banded.py:91-113``'s per-glyph x-sort."""
    seg_arrays = [glyph_segments(g) for g in glyphs]
    if sort == "x":
        seg_arrays = [xsort_segments(s) for s in seg_arrays]
    n = len(glyphs)
    b = (n + bands - 1) // bands
    elem_counts = [sum(len(s) for s in seg_arrays[e * bands : (e + 1) * bands])
                   for e in range(b)]
    cap = max(8, ((max(elem_counts, default=0) + 7) // 8) * 8)
    segments = np.zeros((b, cap, 3, 2), np.float32)
    owners = np.zeros((b, cap), np.int32)
    min_x = np.zeros((bands, b), np.int32)
    max_y = np.zeros((bands, b), np.int32)
    for gi, (seg, grid) in enumerate(zip(seg_arrays, grids)):
        e, k = divmod(gi, bands)
        start = sum(len(seg_arrays[e * bands + j]) for j in range(k))
        segments[e, start : start + len(seg)] = seg
        owners[e, start : start + len(seg)] = k
        min_x[k, e] = grid.min_x
        max_y[k, e] = grid.max_y
    return segments, owners, min_x, max_y, cap


def dejavu_case(glyphs, upem: int, size: int) -> Case:
    """The bucket at ``size`` px on ``size x size`` tiles."""
    grids = [RasterGrid.fixed_tile((g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                                   size, upem, size) for g in glyphs]
    segments, owners, min_x, max_y, _ = build_banded(glyphs, grids, 128 // size, sort="x")
    batch = pack_glyphs(glyphs, capacity=BUCKET, sort="x")
    mx, my, scale = grid_anchors(grids)
    return Case(f"dejavu{size}", size, len(glyphs), np.float32(scale),
                (segments, owners, min_x, max_y), (batch.segments, batch.seg_counts, mx, my))


def cjk_case(segs, size: int) -> Case:
    """``tpu_cjk_banded.py``'s strips of ``segs`` (``[n, S, 3, 2]``, ``n`` a
    multiple of ``R``) at ``size`` px."""
    n, s = segs.shape[:2]
    bands = 128 // size
    b = n // bands
    owners = np.repeat(np.arange(bands, dtype=np.int32), s)[None, :].repeat(b, axis=0)
    min_x = np.zeros(n, np.int32)
    max_y = np.full(n, size - 1, np.int32)
    return Case(f"synth{size}", size, n, np.float32(size / cjk.UPEM),
                (segs.reshape(b, bands * s, 3, 2), owners, min_x.reshape(b, bands).T.copy(),
                 max_y.reshape(b, bands).T.copy()),
                (segs, np.full(n, s, np.int32), min_x, max_y))


def cases(limit: int | None = None) -> list[Case]:
    """The four cases, each of its first ``limit`` glyphs (a multiple of 4,
    so that the CJK strips are whole)."""
    font = Font.open(DEJAVU)
    glyphs = bucket(font, limit)
    segs = cjk.make_batch(CJK_GLYPHS, CJK_SEGMENTS)[:limit]
    return ([dejavu_case(glyphs, font.info.units_per_em, size) for size in SIZES]
            + [cjk_case(segs, size) for size in SIZES])


def strip_inputs(case: Case, dev):
    """``winding_banded_batch``'s arguments on ``dev``."""
    segments, owners, min_x, max_y = (torch.from_numpy(a).to(dev) for a in case.strip)
    return segments, owners, min_x, max_y, float(case.scale)


def glyph_inputs(case: Case, dev):
    """``winding_batch``'s arguments on ``dev`` (no live counts)."""
    segments, _, min_x, max_y = case.glyph
    return (*(torch.from_numpy(a).to(dev) for a in (segments, min_x, max_y)),
            float(case.scale))


def strips(case: Case, args):
    """The strips: one ``winding_banded_batch`` call."""
    return winding.winding_banded_batch(*args, width=case.size)


def per_glyph(case: Case, args):
    """The per-glyph maps: one ``winding_batch`` call."""
    return winding.winding_batch(*args, height=case.size, width=case.size)


def strip_maps(case: Case, out):
    """The strips ``[B, 128, W]`` cut into one map a glyph: ``[glyphs,
    size, W]``."""
    return out.reshape(-1, case.size, out.shape[2])[: case.glyphs]


def measure(case: Case, sargs, gargs, strip_out, glyph_out) -> dict:
    """The case's record: the pixels where the strips ``strip_out`` differ
    from the per-glyph maps ``glyph_out``, each kernel's bound and, on a
    card, its device ms (CUDA-graph replays) and wrapper ms (CUDA events
    around 10 calls)."""
    segments, owners, _, max_y = case.strip
    bands = max_y.shape[0]
    ops, crossings = bound.banded_work(segments, owners, max_y, case.scale, width=case.size)
    nbytes = bound.banded_bytes(segments, owners, bands, case.size)
    g_ops, g_bytes, _ = bound.winding_work(case.glyph[0], case.glyph[1], case.glyph[3],
                                           case.scale, height=case.size, width=case.size)
    rec = dict(case=case.name, size=case.size, bands=bands, glyphs=case.glyphs,
               elements=len(segments), segments=int(case.glyph[1].sum()),
               differ=int((strip_maps(case, strip_out) != glyph_out).sum()),
               ink=int((glyph_out != 0).sum()), crossings=crossings)
    rec["bound_ms"], rec["bound_by"] = bound.bound_ms(nbytes, ops)
    rec.update(bound_ops=ops, bound_bytes=nbytes)
    rec["winding_bound_ms"], rec["winding_bound_by"] = bound.bound_ms(g_bytes, g_ops)
    if strip_out.is_cuda:
        rec["ms"] = graph_ms(lambda: strips(case, sargs))
        rec["call_ms"] = cuda_ms(lambda: strips(case, sargs), inner=10)
        rec["winding_ms"] = graph_ms(lambda: per_glyph(case, gargs))
        rec["winding_call_ms"] = cuda_ms(lambda: per_glyph(case, gargs), inner=10)
        rec["card"] = smi("name,power.limit", strip_out.device.index or 0)
    else:
        rec.update(ms=None, call_ms=None, winding_ms=None, winding_call_ms=None, card=None)
    return rec


def run_case(case: Case, dev) -> dict:
    """Both kernels once on ``dev``, counted, then ``measure``."""
    sargs, gargs = strip_inputs(case, dev), glyph_inputs(case, dev)
    before = winding.banded_launches, winding.launches
    strip_out = strips(case, sargs)
    glyph_out = per_glyph(case, gargs)
    launches = winding.banded_launches - before[0], winding.launches - before[1]
    rec = measure(case, sargs, gargs, strip_out, glyph_out)
    rec["launches"], rec["winding_launches"] = launches
    return rec


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda: the kernels on the first card; cpu: their plain versions")
    args = parser.parse_args(argv)
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu for the plain versions")
    failed = []
    for case in cases():
        rec = run_case(case, dev)
        print(json.dumps(rec), flush=True)
        if rec["differ"]:
            failed.append(case.name)
    if failed:
        raise SystemExit(f"strips differ from the per-glyph maps: {', '.join(failed)}")


if __name__ == "__main__":
    main()
