"""The CUDA Loop-Blinn triangle kernel (``csrc/loopblinn.cu``) and its
wrapper, with ``debug_render``, the host drawing of the triangle classes.

The kernel replaces the TPU's triangle kernel,
``loopblinn.py::_make_lb_kernel`` (launcher ``loopblinn_pallas_batch``);
see the note in the source. A tensor on the CPU goes to the plain version,
``loopblinn_ref``. A CUDA tensor goes to the kernel, and a failed build or
launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch import device as _device
from fontrx_torch.convert import triangles_to_device
from fontrx_torch.kernels import _build, loopblinn_ref
from fontrx_torch.kernels.loopblinn_ref import CLASS_PAD
from fontrx_torch.kernels.winding import _check

SOURCE = "fontrx_torch/csrc/loopblinn.cu"

# launches of the kernel in this process; the wrapper adds one per launch
launches = 0


def _pack_triangle_arrays(tri_glyph) -> np.ndarray:
    """TriangulatedGlyph -> per-triangle vertex/texcoord arrays:
    float32 ``[M, 3 (corner), 4 (x y u v)]``."""
    v = tri_glyph.vertices.astype(np.float32)
    t = tri_glyph.texcoords.astype(np.float32)
    vt = np.concatenate([v, t], axis=1)  # [N, 4]
    return vt[tri_glyph.triangles]  # [M, 3, 4]


def pad_triangles(tris: np.ndarray, classes: np.ndarray, capacity: int):
    """Zero-pad triangle arrays to ``capacity``: the padding rows have class
    3 and zero area, and never draw."""
    m = len(tris)
    out = np.zeros((capacity, 3, 4), np.float32)
    out[:m] = tris
    cls = np.full(capacity, CLASS_PAD, np.int32)
    cls[:m] = classes
    return out, cls


def pack_meshes(meshes):
    """TriangulatedGlyphs -> one padded batch, as
    ``benchmarks/configs.py:152-176`` packs config 3: float32
    ``[B, M, 3, 4]`` triangles and int32 ``[B, M]`` classes, ``M`` the most
    triangles of any mesh (at least 1)."""
    cap = max([len(m.triangles) for m in meshes] + [1])
    tris = np.zeros((len(meshes), cap, 3, 4), np.float32)
    classes = np.full((len(meshes), cap), CLASS_PAD, np.int32)
    for i, mesh in enumerate(meshes):
        tris[i], classes[i] = pad_triangles(_pack_triangle_arrays(mesh), mesh.classes, cap)
    return tris, classes


def check_inputs(tris, classes, min_x, max_y, scale, height, width):
    """Check what the kernel takes: float32 ``[B, M, 3, 4]`` triangles,
    int32 ``[B, M]`` classes and int32 ``[B]`` anchors, contiguous on one
    CUDA device, a finite ``scale > 0`` and a size >= 0. Returns
    ``(B, M, float32 scale)``."""
    if tris.dim() != 4 or tris.shape[2:] != (3, 4):
        raise ValueError(f"tris must be [B, M, 3, 4], got {tuple(tris.shape)}")
    b, m = tris.shape[:2]
    _check("tris", tris, torch.float32, (b, m, 3, 4))
    _check("classes", classes, torch.int32, (b, m))
    _check("min_x", min_x, torch.int32, (b,))
    _check("max_y", max_y, torch.int32, (b,))
    if any(t.device != tris.device for t in (classes, min_x, max_y)):
        raise ValueError("tris, classes, min_x and max_y must be on one device")
    scale = np.float32(scale)
    if not (np.isfinite(scale) and scale > 0):
        raise ValueError(f"scale must be finite and > 0, got {scale}")
    if height < 0 or width < 0:
        raise ValueError(f"bad raster size {height}x{width}")
    return b, m, scale


def loopblinn_batch(
    tris, classes, min_x, max_y, scale, *, height, width, sample_offset=(0.0, 0.0)
):
    """Batched triangle-mesh fill: bool ``[B, height, width]``.

    ``tris`` float32 ``[B, M, 3, 4]`` (x y u v per corner), ``classes``
    int32 ``[B, M]`` (0 concave, 1 convex, 2 solid, 3 padding),
    ``min_x``/``max_y`` int32 ``[B]`` on one device; ``scale`` (> 0) and
    ``sample_offset`` are host numbers, rounded to float32. Same arguments
    and result as ``loopblinn_ref.loopblinn_batch``.
    """
    global launches
    if tris.device.type == "cpu":
        return loopblinn_ref.loopblinn_batch(
            tris, classes, min_x, max_y, scale, height=height, width=width,
            sample_offset=sample_offset,
        )
    b, m, scale = check_inputs(tris, classes, min_x, max_y, scale, height, width)
    ox, oy = (np.float32(v) for v in sample_offset)
    out = torch.empty((b, height, width), dtype=torch.bool, device=tris.device)
    if out.numel() == 0:
        return out
    lib = _build.load("loopblinn")
    with torch.cuda.device(tris.device):
        stream = torch.cuda.current_stream(tris.device).cuda_stream
        err = lib.loopblinn(
            tris.data_ptr(), classes.data_ptr(), min_x.data_ptr(), max_y.data_ptr(),
            float(scale), float(ox), float(oy), b, m, height, width, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"loopblinn kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def plan(batch, triangles, height, width, sms=None):
    """The launch plan of ``loopblinn()`` for ``batch`` glyphs of
    ``triangles`` triangles on ``height x width`` rasters on a card of
    ``sms`` SMs (the current CUDA device's count when None): ``(rows a band,
    row bands, columns a band, column bands, triangles a chunk, chunks)``
    from the library's ``loopblinn_plan()``, None for an empty launch."""
    if sms is None:
        sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    out = np.zeros(6, np.int32)
    err = _build.load("loopblinn").loopblinn_plan(batch, triangles, height, width, sms,
                                                  out.ctypes.data)
    return None if err else tuple(int(v) for v in out)


def loopblinn_fill(tri_glyph, grid, device=None) -> np.ndarray:
    """One glyph's triangle-mesh fill: uint8 ``[H, W]``, 255 where covered,
    on ``grid``. ``device=None`` means the first CUDA device; the CPU runs
    the plain version only when the caller passes ``"cpu"``."""
    dev = _device.require_cuda() if device is None else torch.device(device)
    tris, classes = pack_meshes([tri_glyph])
    args = triangles_to_device(tris, classes, [grid], dev)
    out = loopblinn_batch(*args, height=grid.height, width=grid.width)
    return np.where(out[0].cpu().numpy(), 255, 0).astype(np.uint8)


def debug_render(tri_glyph, grid) -> np.ndarray:
    """The triangle classes drawn for ``-d``: concave red, convex green,
    solid blue; the kept side of each curve test at alpha 0.5, the
    discarded side at 0.2; alpha-composited in triangle order over black.
    uint8 ``[H, W, 3]``. Host NumPy, a copy of the original
    (``fontrx/kernels/loopblinn.py:156-198``); no kernel runs."""
    tris = _pack_triangle_arrays(tri_glyph)
    classes = tri_glyph.classes
    xs, ys = grid.sample_coords()
    px = xs[None, :]
    py = ys[:, None]
    img = np.zeros((grid.height, grid.width, 3), np.float32)
    colors = {0: (1.0, 0, 0), 1: (0, 1.0, 0), 2: (0, 0, 1.0)}
    for tri, c in zip(tris, classes):
        (ax, ay, au, av), (bx, by, bu, bv), (cx, cy, cu, cv) = tri
        e0 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        e1 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
        e2 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        if area == 0:
            continue
        sgn = np.sign(area)
        inside = (e0 * sgn >= 0) & (e1 * sgn >= 0) & (e2 * sgn >= 0)
        la, lb = e1 / area, e2 / area
        lc = 1.0 - la - lb
        u = la * au + lb * bu + lc * cu
        v = la * av + lb * bv + lc * cv
        f = (1 + u - v) ** 2
        if c == 0:
            kept = f >= 4 * u
        elif c == 1:
            kept = f <= 4 * u
        else:
            kept = np.ones_like(f, bool)
        alpha = np.where(inside, np.where(kept, 0.5, 0.2), 0.0)[..., None]
        img = img * (1 - alpha) + np.array(colors[int(c)]) * alpha
    return np.clip(img * 255, 0, 255).astype(np.uint8)
