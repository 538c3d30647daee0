"""Entry points: the raster step of the glyph fill path, an example batch,
and the multi-device dry runs.

The port of ``__graft_entry__.entry()`` (the same 128 x 640 raster of the
same example batch, through ``RasterEngine.winding_batch``), of its
``dryrun_multichip`` (every sharded family over one mesh, each held to its
plain version under the same sharding) and of its ``dryrun_multihost``
(processes that stand in for hosts, joined by ``torch.distributed``).
"""

from __future__ import annotations

import queue
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fontrx_torch.convert import to_device
from fontrx_torch.device import require_cuda
from fontrx_torch.engine import sharding
from fontrx_torch.engine.raster import RasterEngine
from fontrx_torch.kernels import winding

HEIGHT, WIDTH = 128, 640
# the multi-host dry run fails when its ranks have not ended by then, as the
# reference's does (__graft_entry__.py:238)
MULTIHOST_TIMEOUT_S = 600.0


def _example_batch(b=8, s=64, tile=128):
    """Deterministic batch of synthetic quadratic segments (no font file
    dependency): simple closed diamonds with curved sides."""
    rng = np.random.default_rng(0)
    segments = np.zeros((b, s, 3, 2), np.float32)
    for i in range(b):
        n = 4
        corners = np.array(
            [[100, 0], [200, 100], [100, 200], [0, 100]], np.float32
        ) + rng.integers(0, 20, (4, 2))
        for k in range(n):
            p0 = corners[k]
            p2 = corners[(k + 1) % n]
            p1 = (p0 + p2) / 2 + rng.integers(-30, 30, 2)
            segments[i, k] = [p0, p1, p2]
    min_x = np.full(b, -1, np.int32)
    max_y = np.full(b, tile - 2, np.int32)
    scale = np.float32(0.5)
    return segments, min_x, max_y, scale


def entry(device="cuda"):
    """Returns ``(fn, example_args)``: ``fn(*example_args)`` rasters the
    example batch on ``device`` and returns its float32 ``[8, 128, 640]``
    nonzero mask."""
    engine = RasterEngine(device=device)

    def fn(segments, min_x, max_y, scale):
        winding_map = engine.winding_batch(
            segments, min_x, max_y, scale, height=HEIGHT, width=WIDTH
        )
        return (winding_map != 0).to(torch.float32)

    return fn, to_device(*_example_batch(tile=HEIGHT), device)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run failed: {what}")


def _mesh_devices(n: int, device) -> list | None:
    """``None`` (every card, round robin) for ``device=None``, else ``n``
    times ``device``."""
    return None if device is None else [torch.device(device)] * n


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded raster step of every family over an ``n_devices``-shard
    mesh, each held to its plain version under the same sharding: the port
    of ``__graft_entry__.dryrun_multichip`` (``:251-462``).

    ``device=None`` lays the mesh over the visible cards, round robin (all
    shards on ``cuda:0`` of a one-card machine), and raises with no card;
    ``device="cpu"`` lays it over the CPU, where every shard runs the plain
    version. The legs are the reference's, on its example batch (2 glyphs a
    shard): the 1-D glyph mesh (8 x 128 tiles), the glyphs x rows mesh when
    ``n_devices`` is even (128-row bands), the SDF (32 x 32), the Loop-Blinn
    fill (two solid triangles a glyph, glyph ``i``'s ``4i`` px to the right,
    so that no two glyphs are alike), 2 x 2 coverage and the dense tile (128
    x 128), and a 1024-wide page of ``128 * n_devices`` rows in row bands.
    The 8-row legs take ``ink_anchors``, since the reference's put their
    tiles above the glyphs. Each leg's shards equal the plain version's under
    the same sharding, and the gathered result the plain version on one
    shard, which must have ink: so a shard out of order fails. Every
    comparison is bit for bit, but for the SDF, which keeps the reference's
    ``< 8/127`` on the field clipped to +-8. Raises ``RuntimeError`` on a
    failed leg.
    """
    mesh = sharding.make_mesh(n_devices, _mesh_devices(n_devices, device))
    b = n_devices * 2  # 2 glyphs a shard
    tile_h, tile_w = 8, 128
    segments, min_x, max_y, scale = _example_batch(b=b, s=8, tile=tile_w)
    args = tuple(torch.from_numpy(a) for a in (segments, min_x, max_y))
    on_ink = (*args[:2], torch.from_numpy(ink_anchors(b)))  # for the 8-row legs

    def leg(name, fn, *fn_args, on=mesh, equal=torch.equal, **kw):
        """Run a leg on the mesh ``on`` and its plain version under the same
        sharding and on one shard; check that each shard lies on its device
        and equals the plain one, and that the gathered result has ink and
        equals the one-shard result; returns the gathered result."""
        out = fn(*fn_args, mesh=on, **kw)
        ref = fn(*fn_args, mesh=on, plain=True, **kw)
        _check([t.device for t in out] == on.flat(), f"{name}: a shard is off its device")
        _check(all(map(equal, out, ref)), f"{name} differs from the plain version")
        one = sharding.Mesh(on.devices.reshape(-1)[:1].reshape((1,) * on.devices.ndim),
                            on.axis_names)
        whole = sharding.gather(on, out)
        _check(bool((whole != 0).any()), f"{name}: no ink")
        _check(equal(whole, sharding.gather(one, fn(*fn_args, mesh=one, plain=True, **kw))),
               f"{name}: the gathered shards differ from the unsharded result")
        return whole

    out = leg("sharded winding", sharding.winding_sharded, *on_ink, scale, height=tile_h,
              width=tile_w)
    _check(out.shape == (b, tile_h, tile_w), f"1-D shape {tuple(out.shape)}")

    if n_devices % 2 == 0:
        mesh2 = sharding.make_mesh_2d(n_devices // 2, 2, mesh.flat())
        h2 = 2 * 128
        out2 = leg("2-D sharded winding", sharding.winding_sharded_2d, *args, scale,
                   height=h2, width=tile_w, on=mesh2)
        _check(out2.shape == (b, h2, tile_w), f"2-D shape {tuple(out2.shape)}")

    def sdf_close(s, r):
        return float((s.clamp(-8, 8) - r.clamp(-8, 8)).abs().max()) < 8.0 / 127

    leg("sharded SDF", sharding.sdf_sharded, *args, scale, height=32, width=32,
        equal=sdf_close)

    tris = torch.zeros((b, 2, 3, 4), dtype=torch.float32)
    tris[:, 0, :, :2] = torch.tensor([[0.0, 0.0], [120.0, 0.0], [0.0, 120.0]])
    tris[:, 1, :, :2] = torch.tensor([[120.0, 0.0], [120.0, 120.0], [0.0, 120.0]])
    tris[..., 0] += 8.0 * torch.arange(b)[:, None, None]  # glyph i 4i px to the right
    classes = torch.full((b, 2), 2, dtype=torch.int32)  # solid
    leg("sharded Loop-Blinn", sharding.loopblinn_sharded, tris, classes, *on_ink[1:], scale,
        height=tile_h, width=tile_w)
    leg("sharded coverage", sharding.coverage_sharded, *args, scale, height=128, width=tile_w,
        samples=2)
    # the reference's dense leg (K2's map at its 128-row tile): one kernel here
    leg("sharded dense tile", sharding.winding_sharded, *args, scale, height=tile_w,
        width=tile_w)

    row_mesh = sharding.make_row_mesh(devices=mesh.flat())
    page_h, page_w = n_devices * 128, 1024  # the K7 route from 1024 columns
    flat = torch.from_numpy(segments[:1] * np.float32(4.0))  # page-space segments
    pg = leg("sharded page", sharding.page_rows_sharded, flat, page_h, page_w, on=row_mesh)
    _check(pg.shape[0] >= page_h and pg.shape[1] >= page_w, f"page shape {tuple(pg.shape)}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ink_anchors(b: int) -> np.ndarray:
    """``max_y`` anchors for 8-row tiles of the example batch: glyph ``i``'s
    tile samples rows ``a_i`` down to ``a_i - 7`` px, ``a_i = 8 + 6 (i mod
    9)``, across its diamond (0 to ~110 px high) and the dry run's two solid
    triangles (0 to 60 px), and the tiles of 9 glyphs in a row differ. The
    reference's anchors put the tiles above the glyphs, so their maps are
    empty and a shard in the wrong place would pass."""
    return (8 + 6 * (np.arange(b) % 9)).astype(np.int32)


def multihost_batch(b: int):
    """The multi-host leg's inputs: the example batch's segments on 8 x 128
    tiles at ``ink_anchors``."""
    segments, min_x, _, scale = _example_batch(b=b, s=8, tile=128)
    return segments, min_x, ink_anchors(b), scale


def _multihost_worker(rank: int, n_proc: int, port: int, local_devices: int, device,
                      results) -> None:
    """Rank ``rank`` of the multi-host dry run: it joins the gloo group,
    rasters its ``local_devices`` shards of the process-spanning glyph mesh
    on its device, checks each against the plain version, all-gathers the
    shards and checks the whole map against the unsharded one. It puts
    ``(rank, winding() launches, the gathered map or None)`` on
    ``results``."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n_proc, rank=rank)
    try:
        if device is None:
            require_cuda()
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            dev = torch.device(device)
        b = n_proc * local_devices * 2  # 2 glyphs a shard
        tile_h, tile_w = 8, 128
        segments, min_x, max_y, scale = multihost_batch(b)
        per_rank = b // n_proc
        mine = slice(rank * per_rank, (rank + 1) * per_rank)
        local = tuple(torch.from_numpy(a[mine]) for a in (segments, min_x, max_y))
        mesh = sharding.make_mesh(devices=[dev] * local_devices)
        launches = winding.launches
        out = sharding.winding_sharded(*local, scale, height=tile_h, width=tile_w, mesh=mesh)
        launches = winding.launches - launches
        ref = sharding.winding_sharded(*local, scale, height=tile_h, width=tile_w, mesh=mesh,
                                       plain=True)
        _check(all(t.device == dev for t in out), f"rank {rank}: shards not on {dev}")
        _check(all(map(torch.equal, out, ref)),
               f"rank {rank}: a shard differs from the plain version")

        # the host link stands in for the data-centre network: CPU tensors over gloo
        part = sharding.gather(mesh, out, "cpu")
        parts = [torch.empty_like(part) for _ in range(n_proc)]
        dist.all_gather(parts, part)
        gathered = torch.cat(parts)
        unsharded = winding.winding_batch(*to_device(segments, min_x, max_y, scale, dev),
                                          height=tile_h, width=tile_w).cpu()
        _check(torch.equal(gathered, unsharded),
               f"rank {rank}: the gathered map differs from the unsharded map")
        results.put((rank, launches, gathered.numpy() if rank == 0 else None))
    finally:
        dist.destroy_process_group()


def dryrun_multihost(n_proc: int = 2, local_devices: int = 4, device=None):
    """The multi-host dry run: ``n_proc`` processes stand in for hosts, each
    holding ``local_devices`` shards of one glyph mesh that spans them; the
    port of ``__graft_entry__.dryrun_multihost`` (``:114-249``).

    The processes (``torch.multiprocessing.spawn``) join a
    ``torch.distributed`` group over ``tcp://127.0.0.1:<free port>``. Each
    rank rasters its shards of ``multihost_batch`` (8 x 128 tiles, 2 glyphs
    a shard) on ``cuda:(rank % device_count)`` (``device=None``;
    with no card it raises) or on ``device``, checks each shard against the
    plain version, and takes part in one ``all_gather`` of the shards as CPU
    tensors, whose result must equal the unsharded map on every rank. The
    backend is gloo: NCCL cannot put two ranks on one card, and on one H100
    the ranks share it.

    Returns ``(gathered, launches)``: rank 0's gathered int32 map, NumPy
    ``[2 * n_proc * local_devices, 8, 128]``, and each rank's count of
    ``winding()`` launches (0 on the CPU). Raises if a rank fails or the
    run outlasts ``MULTIHOST_TIMEOUT_S``; every process it starts has ended
    when it returns."""
    if device is None:
        require_cuda()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = mp.spawn(_multihost_worker,
                     args=(n_proc, _free_port(), local_devices, device, results),
                     nprocs=n_proc, join=False)
    got = {}

    def drain():
        while True:
            try:
                rank, launches, gathered = results.get(timeout=0.1)
            except queue.Empty:
                return
            got[rank] = (launches, gathered)

    deadline = time.monotonic() + MULTIHOST_TIMEOUT_S
    try:
        while not procs.join(timeout=0.5):  # raises when a rank failed
            drain()
            if time.monotonic() > deadline:
                raise RuntimeError(f"multihost dry run: no end after {MULTIHOST_TIMEOUT_S} s")
        drain()
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
    _check(sorted(got) == list(range(n_proc)), f"multihost: results from ranks {sorted(got)}")
    return got[0][1], [got[r][0] for r in range(n_proc)]
