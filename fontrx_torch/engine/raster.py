"""Raster engine: batched winding maps, fills, k x k coverage and signed
distance fields on one device.

The port of ``fontrx.engine.raster.RasterEngine``'s winding, window-packed
atlas, tile coverage and SDF atlas paths. Inputs go to the engine's device;
a CUDA device runs the CUDA kernels and the CPU runs their plain PyTorch
versions (``fontrx_torch.kernels.winding``, ``.coverage`` and ``.sdf``).
One kernel of each serves every tile size, so the TPU's split at 128 px,
its padding to 128-row strips, its per-launch batch cap, its choice between
coverage strategies and its flat/tiled SDF routes are gone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fontrx_torch.convert import grid_anchors, to_device
from fontrx_torch.kernels import coverage, coverage_ref, sdf, winding
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack.segments import PackedBatch, pack_glyphs
from fontrx_torch.pack.windows import SAMPLE_MARGIN, pack_windows, win_rows_for

# the reference's single-tile route: tiles of at most this many rows and
# columns may take a window-packed stream (raster.py:99-110, 175, 196)
DENSE_MAX = 128


def _fixed_tiles(boxes, font_size: int, units_per_em: int, tile: int) -> list[RasterGrid]:
    return [
        RasterGrid.fixed_tile(tuple(box), font_size, units_per_em, tile)
        for box in np.asarray(boxes)
    ]


@dataclass(frozen=True)
class DenseWindows:
    """A window-packed segment stream from ``RasterEngine.pack_windows``,
    on the engine's device: window ``w`` of glyph ``b`` holds
    ``counts[b, w]`` copies of the segments that can reach its rows ``[w *
    win_rows, (w + 1) * win_rows)`` (``fontrx_torch.pack.windows``). Pass
    it to ``winding_batch(windows=...)`` with the same anchors and scale."""

    segments_win: torch.Tensor  # float32 [B, n_windows * cap, 3, 2]
    counts: torch.Tensor        # int32 [B, n_windows]
    n_windows: int
    cap: int
    win_rows: int
    height: int


@dataclass
class RasterEngine:
    """Winding rasters on ``device`` (``"cuda"``, ``"cuda:1"``, ``"cpu"``,
    or a ``torch.device``)."""

    device: torch.device | str

    def __post_init__(self):
        self.device = torch.device(self.device)

    def pack_windows(
        self, segments, min_x, max_y, scale, *, height: int,
    ) -> DenseWindows | None:
        """The window-packed stream of a small-tile atlas batch, packed on
        the host and moved to the engine's device; ``None`` where the
        reference packs none: tiles taller than 128 rows, or fewer than 128
        segment slots a glyph. One pack serves every sample offset with
        ``|oy| <= 1``."""
        segments = torch.as_tensor(segments).cpu().numpy()
        if height > DENSE_MAX or segments.shape[1] < 128:
            return None
        win_rows = win_rows_for(height)
        win, counts, n_windows, cap = pack_windows(
            segments, np.asarray(max_y), float(np.float32(scale)), height, win_rows=win_rows)
        return DenseWindows(
            segments_win=torch.from_numpy(win).to(self.device),
            counts=torch.from_numpy(counts).to(self.device),
            n_windows=n_windows, cap=cap, win_rows=win_rows, height=height)

    def winding_batch(
        self, segments, min_x, max_y, scale, *, height: int, width: int,
        sample_offset=(0.0, 0.0), windows: DenseWindows | None = None,
    ) -> torch.Tensor:
        """Batched winding maps: int32 ``[B, height, width]`` on the
        engine's device. ``segments`` ``[B, S, 3, 2]`` and the anchors
        ``min_x``/``max_y`` ``[B]`` may be NumPy arrays or tensors.

        ``windows`` (from ``pack_windows`` over the same batch, anchors and
        scale) routes a tile of at most 128 x 128 packed for this height
        through the window-packed kernel, which reads the stream and not
        ``segments``; any other call takes the unwindowed kernel, as the
        reference routes it. The stream's rows carry a margin of
        ``SAMPLE_MARGIN`` pixels, so a windowed call takes ``|oy|`` up to
        that margin."""
        if (windows is not None and windows.height == height
                and height <= DENSE_MAX and width <= DENSE_MAX):
            if windows.segments_win.shape[0] != len(segments):
                raise ValueError(f"windows were packed for {windows.segments_win.shape[0]} "
                                 f"glyphs, not {len(segments)}")
            if not abs(float(sample_offset[1])) <= SAMPLE_MARGIN:
                raise ValueError(f"sample offset y {sample_offset[1]} is beyond the pack's "
                                 f"{SAMPLE_MARGIN} px margin")
            _, min_x, max_y, scale = to_device(
                windows.segments_win, min_x, max_y, scale, self.device)
            return winding.winding_windows_batch(
                windows.segments_win, windows.counts, min_x, max_y, scale,
                height=height, width=width, win_rows=windows.win_rows,
                sample_offset=sample_offset,
            )
        segments, min_x, max_y, scale = to_device(
            segments, min_x, max_y, scale, self.device)
        return winding.winding_batch(
            segments, min_x, max_y, scale, height=height, width=width,
            sample_offset=sample_offset,
        )

    def winding_glyph(self, segments, grid: RasterGrid) -> torch.Tensor:
        """Single-glyph winding map ``[H, W]`` over an oracle-convention
        grid (BASELINE config 1)."""
        return self.winding_batch(
            np.asarray(segments, np.float32)[None], [grid.min_x], [grid.max_y], grid.scale,
            height=grid.height, width=grid.width,
        )[0]

    def winding_packed(
        self, batch: PackedBatch, font_size: int, units_per_em: int, tile: int
    ) -> tuple[torch.Tensor, list[RasterGrid]]:
        """Raster a ``PackedBatch`` into fixed ``tile x tile`` maps anchored
        at each glyph's bbox corner: ``([B, T, T] winding, grids)``."""
        grids = _fixed_tiles(batch.boxes, font_size, units_per_em, tile)
        out = self.winding_batch(
            batch.segments, *grid_anchors(grids), height=tile, width=tile)
        return out, grids

    def winding_packed_banded(
        self, glyphs, font_size: int, units_per_em: int, tile: int
    ) -> tuple[torch.Tensor, list[RasterGrid]]:
        """Small-tile atlas raster from glyphs, x-sorted per glyph. The
        reference's banded kernels are gone from its routing; like it, this
        is the plain engine path."""
        grids = [
            RasterGrid.fixed_tile(
                (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                font_size, units_per_em, tile,
            )
            for g in glyphs
        ]
        batch = pack_glyphs(glyphs, sort="x")
        out = self.winding_batch(
            batch.segments, *grid_anchors(grids), height=tile, width=tile)
        return out, grids

    def winding_split(
        self, split, font_size: int, units_per_em: int, tile: int
    ) -> tuple[torch.Tensor, list[RasterGrid]]:
        """Raster a ``SplitBatch``: one launch over all rows, then
        ``index_add_`` folds each glyph's rows into its winding map (exact:
        integer sums commute). Returns ``([G, T, T] winding, grids)``."""
        grids = _fixed_tiles(split.boxes, font_size, units_per_em, tile)
        rows = self.winding_batch(
            split.segments, *grid_anchors(grids), height=tile, width=tile)
        owner = torch.as_tensor(np.asarray(split.row_owner, np.int64), device=self.device)
        summed = torch.zeros(
            (split.num_glyphs, tile, tile), dtype=torch.int32, device=self.device)
        summed.index_add_(0, owner, rows)
        first = np.searchsorted(split.row_owner, np.arange(split.num_glyphs))
        return summed, [grids[i] for i in first]

    def winding_hybrid(
        self, hb, font_size: int, units_per_em: int, tile: int
    ) -> tuple[torch.Tensor, list[RasterGrid]]:
        """Raster a ``HybridBatch``: one launch over all rows; single-row
        glyphs pass through and ``r``-row glyphs fold with a reshape and
        sum. Returns ``([G, T, T] winding in hb.order, grids)``."""
        grids = _fixed_tiles(hb.boxes, font_size, units_per_em, tile)
        rows = self.winding_batch(
            hb.segments, *grid_anchors(grids), height=tile, width=tile)
        parts = []
        glyph_grids: list[RasterGrid] = []
        row = 0
        for r, n in hb.groups:
            block = rows[row : row + r * n]
            parts.append(block if r == 1 else block.reshape(n, r, tile, tile).sum(
                dim=1, dtype=torch.int32))
            glyph_grids.extend(grids[row + k * r] for k in range(n))
            row += r * n
        if not parts:
            return torch.zeros((0, tile, tile), dtype=torch.int32,
                               device=self.device), glyph_grids
        return torch.cat(parts), glyph_grids

    def coverage_batch(
        self, segments, min_x, max_y, scale, *, height: int, width: int,
        samples: int = 2,
    ) -> torch.Tensor:
        """Batched k x k supersampled coverage (the MSAA analog), k =
        ``samples``: float32 ``[B, height, width]`` in [0, 1] on the
        engine's device. Same inputs as ``winding_batch``."""
        segments, min_x, max_y, scale = to_device(
            segments, min_x, max_y, scale, self.device)
        return coverage.coverage_batch(
            segments, min_x, max_y, scale, height=height, width=width,
            samples=samples,
        )

    coverage_to_gray = staticmethod(coverage_ref.coverage_to_gray)

    def sdf_batch(
        self, segments, min_x, max_y, scale, *, height: int, width: int,
        spread_px: float = 8.0,
    ) -> torch.Tensor:
        """Batched signed distance fields (BASELINE config 4): float32
        ``[B, height, width]`` in pixels on the engine's device, positive
        inside, clamped at ``+-spread_px`` on every device (the TPU
        kernels' contract). Same inputs as ``winding_batch``.

        There is no ``pack`` argument and no ``pack_sdf``: the kernel culls
        segments per pixel tile itself, so the host packs nothing."""
        segments, min_x, max_y, scale = to_device(
            segments, min_x, max_y, scale, self.device)
        return sdf.sdf_batch(
            segments, min_x, max_y, scale, height=height, width=width,
            spread_px=spread_px,
        )

    sdf_to_u8 = staticmethod(sdf.sdf_to_u8)

    @staticmethod
    def fill(winding_map: torch.Tensor) -> torch.Tensor:
        """Nonzero-winding rule -> 0/255 uint8."""
        return torch.where(winding_map != 0, 255, 0).to(torch.uint8)

    @staticmethod
    def gray(winding_map: torch.Tensor) -> torch.Tensor:
        """The reference's winding visualization ``clamp(w*20+100, 0, 255)``."""
        return torch.clamp(winding_map * 20 + 100, 0, 255).to(torch.uint8)
