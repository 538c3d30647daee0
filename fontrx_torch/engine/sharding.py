"""Multi-device raster sharding: the port of ``fontrx/engine/sharding.py``.

The reference lays a ``jax.sharding.Mesh`` over a ``glyphs`` axis (and a
``rows`` axis of pixel-row bands) and runs each kernel under ``shard_map``,
one shard per device. Here one process does the same by hand, as the
reference's single controller does: it splits the batch into equal shards,
puts each on its mesh device and calls the kernel's wrapper there. Every
family runs the port's kernels:

- ``winding_sharded`` and ``winding_sharded_2d``: ``winding()`` in
  ``csrc/winding.cu`` (``kernels.winding.winding_batch``). It replaces K4
  (``winding_pallas.py::winding_pallas_batch``), the TPU kernel these two
  run, and K1, so the reference's route split by band height (K1 for bands
  of 128k rows, K4 for 8k, refused otherwise) is gone: one kernel serves
  every band, and only ``height % n_rows == 0`` stays. The reference's
  ``dense_sharded`` (K2's map at a 128-row tile) is ``winding_sharded`` at
  ``height=128``;
- ``coverage_sharded``: ``csrc/coverage.cu`` (K9), one strategy;
- ``sdf_sharded``: ``csrc/sdf.cu`` (K10 and K11), one route;
- ``loopblinn_sharded``: ``csrc/loopblinn.cu`` (K12);
- ``page_rows_sharded``: ``page()`` in ``csrc/page.cu`` (K7, and the
  narrow route beside it).

``plain=True`` runs each shard's plain PyTorch version instead (the
reference's ``use_pallas=False``), for the dry runs' cross-checks.

A mesh names its axes, and each family takes the mesh of its axes only: a
glyph mesh, glyphs x rows, or a page's rows. A result is the list of its
shards, in the mesh's order, each on its device; ``gather`` assembles them
on one device (the reference's ``replicate_out``, its replicated
all-gather). Launches on different cards overlap, since no
wrapper synchronises; shards on one card queue one after another.

``devices=None`` means every visible CUDA card, and with no card a mesh
raises. A mesh of more shards than cards places them round robin: on one
card, all eight shards of ``make_mesh(8)`` sit on ``cuda:0``. That is the
counterpart of the reference's ``--xla_force_host_platform_device_count``,
which makes eight virtual devices of one CPU. The tests pass CPU devices
explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fontrx_torch.device import require_cuda
from fontrx_torch.kernels import (
    coverage, coverage_ref, loopblinn, loopblinn_ref, page, page_ref, sdf, sdf_ref, winding,
    winding_ref)

GLYPH_AXIS = "glyphs"
ROW_AXIS = "rows"
# the page's rows are padded to a multiple of this many rows per shard: the
# 128-row strips of the page kernels' chunk cull are anchored at each band's
# first row (sharding.py:424-426)
PAGE_STRIP_ROWS = 128
PAGE_TILE_W = 128


@dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out along named axes: ``devices`` is an object array of
    ``torch.device``, one array axis per name of ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return self.devices.size

    def flat(self) -> list[torch.device]:
        """The devices in mesh order (the last axis fastest)."""
        return list(self.devices.flat)


def _devices(n: int | None, devices) -> np.ndarray:
    """``n`` devices (all of them for ``None``): the visible cards round robin
    when ``devices`` is ``None``, else the first ``n`` of ``devices``."""
    if devices is None:
        require_cuda()
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(count if n is None else n)]
    devices = [torch.device(d) for d in devices]
    if n is not None:
        if len(devices) < n:
            raise ValueError(f"a mesh of {n} shards needs {n} devices, got {len(devices)}")
        devices = devices[:n]
    out = np.empty(len(devices), dtype=object)
    out[:] = devices
    return out


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the glyph axis (the atlas scales out by data
    parallelism)."""
    return Mesh(_devices(n_devices, devices), (GLYPH_AXIS,))


def make_mesh_2d(n_glyph: int, n_rows: int, devices=None) -> Mesh:
    """2-D mesh, glyphs x row bands: data parallelism over the batch crossed
    with spatial parallelism over pixel-row bands. Winding is per row, so the
    bands are independent."""
    return Mesh(_devices(n_glyph * n_rows, devices).reshape(n_glyph, n_rows),
                (GLYPH_AXIS, ROW_AXIS))


def make_row_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over a page's pixel-row bands (one large page, spatially
    parallel)."""
    return Mesh(_devices(n_devices, devices), (ROW_AXIS,))


def _expect_axes(mesh: Mesh, *names: str) -> None:
    if mesh.axis_names != names:
        raise ValueError(f"this family shards over the axes {names}, not {mesh.axis_names}")


def _shard_len(n: int, shards: int) -> int:
    if n % shards:
        raise ValueError(f"a batch of {n} does not divide into {shards} shards")
    return n // shards


def shard_batch(mesh: Mesh, *arrays) -> tuple[list[torch.Tensor], ...]:
    """Split each array's dim 0 into ``mesh.size`` equal shards, shard ``k``
    on the mesh's ``k``-th device: a list of tensors per array. A batch that
    does not divide raises ``ValueError``, as ``shard_map`` refuses it."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        m = _shard_len(t.shape[0], mesh.size)
        out.append([t[k * m : (k + 1) * m].to(dev).contiguous()
                    for k, dev in enumerate(mesh.flat())])
    return tuple(out)


def gather(mesh: Mesh, shards: list[torch.Tensor], device=None) -> torch.Tensor:
    """The whole result on ``device`` (the mesh's first device by default):
    the shards joined along dim 0, and on a glyphs x rows mesh each glyph
    shard's bands along dim 1 (their pixel rows) first."""
    dev = mesh.flat()[0] if device is None else torch.device(device)
    parts = [s.to(dev) for s in shards]
    if mesh.axis_names == (GLYPH_AXIS, ROW_AXIS):
        n_rows = mesh.devices.shape[1]
        parts = [torch.cat(parts[g : g + n_rows], dim=1) for g in range(0, len(parts), n_rows)]
    return torch.cat(parts)


class WindingShard(NamedTuple):
    """One shard of a sharded winding map: glyphs ``glyphs`` of the batch on
    pixel rows ``[row0, row0 + rows)``, and its inputs on its device, the
    ``max_y`` anchors dropped by ``row0``."""

    glyphs: slice
    row0: int
    rows: int
    segments: torch.Tensor
    min_x: torch.Tensor
    max_y: torch.Tensor


def winding_shards(segments, min_x, max_y, *, height: int, mesh: Mesh) -> list[WindingShard]:
    """The shards of ``winding_sharded`` (a glyph mesh: each shard all
    ``height`` rows) or of ``winding_sharded_2d`` (glyphs x rows: shard
    ``(g, r)`` is glyph shard ``g`` on band ``r`` of ``height / n_rows``
    rows, sharding.py:188-191), in mesh order. Each shard's inputs are cut
    from the batch and moved once, straight to the shard's device."""
    if mesh.axis_names[0] != GLYPH_AXIS:
        raise ValueError(f"a winding map shards over the glyph axis first, not {mesh.axis_names}")
    devices = mesh.devices.reshape(mesh.devices.shape[0], -1)  # glyphs x row bands
    n_glyph, n_rows = devices.shape
    if height % n_rows:
        raise ValueError(f"height {height} does not divide into {n_rows} row bands")
    band_h = height // n_rows
    segments, min_x, max_y = (torch.as_tensor(a) for a in (segments, min_x, max_y))
    m = _shard_len(segments.shape[0], n_glyph)
    shards = []
    for (g, r), dev in np.ndenumerate(devices):
        glyphs, row0 = slice(g * m, (g + 1) * m), r * band_h
        shards.append(WindingShard(glyphs, row0, band_h, *(
            t.to(dev).contiguous()
            for t in (segments[glyphs], min_x[glyphs], max_y[glyphs] - row0))))
    return shards


def _winding(segments, min_x, max_y, scale, height, width, mesh, plain):
    fn = winding_ref.winding_batch if plain else winding.winding_batch
    return [fn(s.segments, s.min_x, s.max_y, scale, height=s.rows, width=width)
            for s in winding_shards(segments, min_x, max_y, height=height, mesh=mesh)]


def winding_sharded(segments, min_x, max_y, scale, *, height: int, width: int, mesh: Mesh,
                    plain: bool = False) -> list[torch.Tensor]:
    """Batched winding maps with the glyph axis sharded over ``mesh``: the
    shards of int32 ``[B, height, width]``. ``B`` must divide by the mesh
    size (pad with empty glyphs: ``pack_glyphs(pad_batch_to=...)``)."""
    _expect_axes(mesh, GLYPH_AXIS)
    return _winding(segments, min_x, max_y, scale, height, width, mesh, plain)


def winding_sharded_2d(segments, min_x, max_y, scale, *, height: int, width: int, mesh: Mesh,
                       plain: bool = False) -> list[torch.Tensor]:
    """Winding maps over a glyphs x row-bands mesh: shard ``(g, r)`` is glyph
    shard ``g`` on rows ``[r * band_h, (r + 1) * band_h)``, int32 ``[B /
    n_glyph, band_h, width]`` (``winding_shards``). ``height`` must divide by
    the row axis."""
    _expect_axes(mesh, GLYPH_AXIS, ROW_AXIS)
    return _winding(segments, min_x, max_y, scale, height, width, mesh, plain)


def coverage_sharded(segments, min_x, max_y, scale, *, height: int, width: int,
                     samples: int = 2, mesh: Mesh, plain: bool = False) -> list[torch.Tensor]:
    """k x k coverage (k = ``samples``) with the glyph axis sharded over
    ``mesh``: the shards of float32 ``[B, height, width]``. The reference's
    ``fused`` and ``exact`` strategies give one result, so they are gone."""
    _expect_axes(mesh, GLYPH_AXIS)
    fn = coverage_ref.coverage_batch if plain else coverage.coverage_batch
    return [fn(seg, mx, my, scale, height=height, width=width, samples=samples)
            for seg, mx, my in zip(*shard_batch(mesh, segments, min_x, max_y))]


def sdf_sharded(segments, min_x, max_y, scale, *, height: int, width: int, mesh: Mesh,
                plain: bool = False) -> list[torch.Tensor]:
    """Signed distance fields with the glyph axis sharded over ``mesh``: the
    shards of float32 ``[B, height, width]``. One kernel serves K10 and K11,
    so the reference's ``flat`` is gone."""
    _expect_axes(mesh, GLYPH_AXIS)
    fn = sdf_ref.sdf_batch if plain else sdf.sdf_batch
    return [fn(seg, mx, my, scale, height=height, width=width)
            for seg, mx, my in zip(*shard_batch(mesh, segments, min_x, max_y))]


def loopblinn_sharded(tris, classes, min_x, max_y, scale, *, height: int, width: int,
                      mesh: Mesh, plain: bool = False) -> list[torch.Tensor]:
    """Triangle-mesh fill with the glyph axis sharded over ``mesh``: the
    shards of bool ``[B, height, width]``."""
    _expect_axes(mesh, GLYPH_AXIS)
    fn = loopblinn_ref.loopblinn_batch if plain else loopblinn.loopblinn_batch
    return [fn(tri, cls, mx, my, scale, height=height, width=width)
            for tri, cls, mx, my in zip(*shard_batch(mesh, tris, classes, min_x, max_y))]


def page_rows_sharded(flat_segments, page_h: int, page_w: int, *, mesh: Mesh,
                      plain: bool = False) -> list[torch.Tensor]:
    """A page's int32 winding with pixel-row bands sharded over ``mesh``.

    ``flat_segments``: float32 ``[1, S, 3, 2]`` page-pixel segments, y up;
    every device holds all of them. The page is padded to ``ph``, a multiple
    of ``128 * n`` rows, and ``pw``, a multiple of 128 columns; shard ``k``
    is rows ``[k * ph / n, (k + 1) * ph / n)``, int32 ``[ph / n, pw]``, and
    row ``r`` of the page samples ``y = page_h - 1 - r``. Each band goes
    through ``kernels.page.direct_page`` with one instance at offset (0, 0)
    and ``s_px`` 1, whose transform ``fma(x, 1, 0)`` is exact. The page
    kernels' chunk cull runs on 128-row strips anchored at each band's first
    row, so bands of 128k rows give the unsharded page's strips; callers
    crop to ``page_h`` x ``page_w``."""
    _expect_axes(mesh, ROW_AXIS)
    n = mesh.size
    ph = _round_up(page_h, PAGE_STRIP_ROWS * n)
    pw = _round_up(page_w, PAGE_TILE_W)
    rows_per = ph // n
    fn = page_ref.direct_page if plain else page.direct_page
    seg = torch.as_tensor(flat_segments).reshape(-1, 3, 2)
    shards = []
    for k, dev in enumerate(mesh.flat()):
        q = seg.to(dev).contiguous()
        owners = torch.zeros(len(q), dtype=torch.int32, device=dev)
        offsets = torch.zeros((1, 2), dtype=torch.float32, device=dev)
        shards.append(fn(q, owners, offsets, 1.0, k * rows_per, page_h=page_h, page_w=pw,
                         out_h=rows_per, mode="winding"))
    return shards


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m
