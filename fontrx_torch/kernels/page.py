"""The CUDA page kernels (``csrc/page.cu``) and their wrappers.

``direct_page`` launches the kernel that replaces the TPU's page kernel, K7
(``winding_page.py::_make_page_kernel``, launcher ``winding_page_batch``),
and the narrow-page route beside it; ``direct_page_msaa`` the one that
replaces its MSAA kernel, K8 (``_make_page_msaa_kernel``, launcher
``winding_page_msaa_batch``), and the narrow route's four passes. Both
compute what the reference computes, its chunk cull included
(``page_ref``); see the note in the source. A tensor on the CPU goes to the
plain version, ``page_ref``. A CUDA tensor goes to the kernel, and a failed
build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch.kernels import _build, page_ref
from fontrx_torch.kernels.page_ref import MODES

SOURCE = "fontrx_torch/csrc/page.cu"

# launches of each kernel in this process; its wrapper adds one per launch:
# the single-sample page (K7's) and the MSAA page (K8's), one a frame each
launches = 0
msaa_launches = 0

_INT32_MAX = 2**31 - 1
# both entries' scratch past their buckets (csrc/page.cu): the counters, and
# the ints of a long segment's record
_COUNTERS = 4
_RECORD_INTS = 16


def _scratch(out_h, width, s, planes, row_offsets, dev):
    """``(stride, scratch)`` of one frame (``csrc/page.cu``): each row's
    ``planes`` int32 bucket planes of ``stride`` cells (16-byte rows), the
    counters, which the entry zeroes, and a record of 16 ints a segment and
    row offset (``kCounters``, ``LongSegment``)."""
    stride = -(-width // 4) * 4
    n = out_h * planes * stride + _COUNTERS + _RECORD_INTS * row_offsets * s
    return stride, torch.empty(n, dtype=torch.int32, device=dev)


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_inputs(flat_segments, seg_inst_idx, inst_offsets, s_px, band_y0, page_h, page_w,
                 out_h, mode, sample_offset=(0.0, 0.0)):
    """Check what the kernels take: float32 ``[S, 3, 2]`` segments, int32
    ``[S]`` owners and float32 ``[N, 2]`` offsets, contiguous on one CUDA
    device, a finite ``s_px > 0``, sizes >= 0, a mode of ``MODES`` and a
    finite sample offset ``(ox, oy)``. Returns ``(S, N, float32 s_px, top,
    float32 ox, float32 oy)``."""
    if flat_segments.dim() != 3 or flat_segments.shape[1:] != (3, 2):
        raise ValueError(f"flat_segments must be [S, 3, 2], got {tuple(flat_segments.shape)}")
    if inst_offsets.dim() != 2 or inst_offsets.shape[1] != 2:
        raise ValueError(f"inst_offsets must be [N, 2], got {tuple(inst_offsets.shape)}")
    s, n = flat_segments.shape[0], inst_offsets.shape[0]
    _check("flat_segments", flat_segments, torch.float32, (s, 3, 2))
    _check("seg_inst_idx", seg_inst_idx, torch.int32, (s,))
    _check("inst_offsets", inst_offsets, torch.float32, (n, 2))
    s_px = np.float32(s_px)
    if not (np.isfinite(s_px) and s_px > 0):
        raise ValueError(f"s_px must be finite and > 0, got {s_px}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    ox, oy = (np.float32(v) for v in sample_offset)
    if not (np.isfinite(ox) and np.isfinite(oy)):
        raise ValueError(f"sample_offset must be finite, got {sample_offset}")
    top = page_h - 1 - band_y0
    if min(page_h, page_w, out_h) < 0 or max(page_w + 1, abs(top) + out_h, s, n) > _INT32_MAX:
        raise ValueError(f"bad page size {page_h}x{page_w}, band ({band_y0}, {out_h})")
    for name, t in (("flat_segments", flat_segments), ("seg_inst_idx", seg_inst_idx),
                    ("inst_offsets", inst_offsets)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not seg_inst_idx.device == inst_offsets.device == flat_segments.device:
        raise ValueError("flat_segments, seg_inst_idx and inst_offsets must be on one device")
    return s, n, s_px, top, ox, oy


def direct_page(flat_segments, seg_inst_idx, inst_offsets, s_px, band_y0=0, *, page_h, page_w,
                out_h=None, mode="fill", sample_offset=(0.0, 0.0)):
    """Rows ``[band_y0, band_y0 + out_h)`` of the page (all of it by
    default) at the sample offset ``(ox, oy)``: ``[out_h, page_w]``, int32
    for ``mode="winding"``, uint8 for ``"fill"`` (0/255) and ``"gray"``
    (the debug gray). Same arguments and result as ``page_ref.direct_page``;
    an owner index outside ``[0, N)`` adds nothing here and raises there."""
    oh = page_h if out_h is None else out_h
    if flat_segments.device.type == "cpu":
        return page_ref.direct_page(
            flat_segments, seg_inst_idx, inst_offsets, s_px, band_y0, page_h=page_h,
            page_w=page_w, out_h=oh, mode=mode, sample_offset=sample_offset)
    s, n, s_px, top, ox, oy = check_inputs(flat_segments, seg_inst_idx, inst_offsets, s_px,
                                           band_y0, page_h, page_w, oh, mode, sample_offset)
    return launch(flat_segments, seg_inst_idx, inst_offsets, s_px, s, n, top, oh, page_w, mode,
                  ox, oy)


def launch(flat_segments, seg_inst_idx, inst_offsets, s_px, s, n, top, out_h, width, mode,
           ox=0.0, oy=0.0):
    """Launch the single-sample kernel on inputs that ``check_inputs`` has
    passed."""
    global launches
    dev = flat_segments.device
    dtype = torch.int32 if mode == "winding" else torch.uint8
    out = torch.empty((out_h, width), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("page")
    chunk, tile_w, x_cull = page_ref.route(width)
    stride, scratch = _scratch(out_h, width, s, 1, 1, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.page(
            flat_segments.data_ptr(), seg_inst_idx.data_ptr(), inst_offsets.data_ptr(),
            s, n, float(s_px), top, out_h, width, MODES.index(mode), chunk, tile_w,
            int(x_cull), float(ox), float(oy), stride, scratch.data_ptr(), out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"page kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def direct_page_msaa(flat_segments, seg_inst_idx, inst_offsets, s_px, *, page_h, page_w):
    """The 2 x 2 MSAA page, uint8 ``[page_h, page_w]`` (0, 63, 127, 191,
    255): ``page_ref.direct_page_msaa``'s arguments and result, in one
    launch of the MSAA kernel on a CUDA device."""
    if flat_segments.device.type == "cpu":
        return page_ref.direct_page_msaa(flat_segments, seg_inst_idx, inst_offsets, s_px,
                                         page_h=page_h, page_w=page_w)
    s, n, s_px, _, _, _ = check_inputs(flat_segments, seg_inst_idx, inst_offsets, s_px, 0,
                                       page_h, page_w, page_h, "fill")
    return launch_msaa(flat_segments, seg_inst_idx, inst_offsets, s_px, s, n, page_h, page_w)


def launch_msaa(flat_segments, seg_inst_idx, inst_offsets, s_px, s, n, height, width):
    """Launch the MSAA kernel on inputs that ``check_inputs`` has passed."""
    global msaa_launches
    dev = flat_segments.device
    out = torch.empty((height, width), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("page")
    chunk, tile_w, x_cull = page_ref.route(width)
    (oy0, (ox0, ox1)), (oy1, _) = page_ref.msaa_lattice()  # both rows share the x pair
    stride, scratch = _scratch(height, width, s, 4, 2, dev)  # the 2 x 2 lattice
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.page_msaa(
            flat_segments.data_ptr(), seg_inst_idx.data_ptr(), inst_offsets.data_ptr(),
            s, n, float(s_px), height, width, chunk, tile_w, int(x_cull), ox0, ox1, oy0, oy1,
            stride, scratch.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"page MSAA kernel launch failed: cudaError_t {err}")
    msaa_launches += 1
    return out
