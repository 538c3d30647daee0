"""Plain PyTorch Loop-Blinn fill: the reference for the CUDA triangle kernel.

The port of ``fontrx.kernels.loopblinn.loopblinn_batch``: per pixel, a
triangle covers it when the pixel's sample point is inside the triangle and
the class test passes on the barycentric-interpolated texcoord ``(u, v)``:

- class 0, concave: keep where ``(1 + u - v)^2 >= 4u``;
- class 1, convex:  keep where ``(1 + u - v)^2 <= 4u``;
- class 2, solid:   always keep;
- class 3, padding: never draws.

Coverage is the OR over triangles. The float32 program follows the JAX
package's operation for operation, with its association: edge functions
``(bx - ax)*(py - ay) - (by - ay)*(px - ax)``, ``inside`` as ``e*sign(area)
>= 0`` for all three edges and ``area != 0``, the barycentric weights as
``e1 * (1/area)`` and ``(1 - la) - lb``. Eager PyTorch rounds every
operation on its own; nothing here may be fused: no ``addcmul``, no
``torch.compile``. Every divisor is a tensor on the data's device (CUDA
division by a CPU scalar multiplies by the reciprocal).
"""

from __future__ import annotations

import torch

from fontrx_torch.kernels.winding_ref import sample_coords

CLASS_CONCAVE = 0
CLASS_CONVEX = 1
CLASS_SOLID = 2
CLASS_PAD = 3

# bytes of live per-pixel temporaries per (glyph, triangle, pixel) element
# of a chunk: three float32 edge functions and their products and masks
_BYTES_PER_ELEMENT = 32
# per-chunk budget: about 32 MiB of temporaries. Small chunks keep a chunk's
# passes in the CPU's caches, which ran faster on config 3's atlas than
# chunks of hundreds of MiB
_CHUNK_BUDGET = 1 << 25


def tri_chunk(batch: int, height: int, width: int) -> int:
    """Triangles per chunk, so that one chunk's per-pixel temporaries stay
    within the budget."""
    per_triangle = max(batch * height * width * _BYTES_PER_ELEMENT, 1)
    return max(1, _CHUNK_BUDGET // per_triangle)


def edges(tri, px, py):
    """The three edge functions and twice the signed area of triangles
    ``tri`` float32 ``[..., 3, 4]`` at sample points ``px``/``py``
    (broadcastable against the triangles' leading dimensions). ``e0`` is
    the edge a->b, ``e1`` b->c, ``e2`` c->a."""
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]
    e0 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    e1 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
    e2 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    return e0, e1, e2, area


def sign(x):
    """``jnp.sign``: -1, 0 or 1, with ``x`` itself for a zero or a NaN
    (``torch.sign`` of a NaN is 0 on the CPU)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def inside_mask(e0, e1, e2, area):
    """The sample point lies inside the triangle or on an edge:
    ``e*sign(area) >= 0`` for all three edges, and ``area != 0``."""
    sgn = sign(area)
    return (e0 * sgn >= 0) & (e1 * sgn >= 0) & (e2 * sgn >= 0) & (area != 0)


def class_test(tri, cls, e1, e2, area):
    """Whether the class test keeps each (triangle, pixel) pair, given the
    pair's triangle ``tri`` float32 ``[N, 3, 4]``, class ``cls`` int32
    ``[N]``, edge functions ``e1``, ``e2`` and ``area`` ``[N]``: bool ``[N]``.
    Only a pair that is inside the triangle may draw, so the caller tests
    inside pairs only; the arithmetic is the same for any pair."""
    one = torch.ones((), dtype=area.dtype, device=area.device)
    inv = torch.where(area != 0, one / torch.where(area == 0, one, area), 0.0)
    la = e1 * inv
    lb = e2 * inv
    lc = (1.0 - la) - lb
    u = (la * tri[:, 0, 2] + lb * tri[:, 1, 2]) + lc * tri[:, 2, 2]
    v = (la * tri[:, 0, 3] + lb * tri[:, 1, 3]) + lc * tri[:, 2, 3]
    q = (1.0 + u) - v
    f = q * q
    u4 = 4.0 * u
    return torch.where(cls == CLASS_CONCAVE, f >= u4,
                       torch.where(cls == CLASS_CONVEX, f <= u4, cls == CLASS_SOLID))


def inside_pairs(tris, min_x, max_y, scale, *, height, width, sample_offset=(0.0, 0.0)):
    """The (glyph, triangle, row, column) pairs whose sample point is inside
    the triangle, one chunk of triangles at a time: yields the indices
    ``(b, m, y, x)`` (int64 ``[N]`` each) and the pairs' ``e1``, ``e2`` and
    ``area``."""
    b, m = tris.shape[:2]
    px, py = sample_coords(
        min_x, max_y, scale, height=height, width=width, sample_offset=sample_offset)
    pxb = px[:, None, None, :]  # [B, 1, 1, W]
    pyb = py[:, None, :, None]  # [B, 1, H, 1]
    step = tri_chunk(b, height, width)
    for m0 in range(0, m, step):
        tri = tris[:, m0 : m0 + step, None, None]  # [B, C, 1, 1, 3, 4]
        e0, e1, e2, area = edges(tri, pxb, pyb)  # [B, C, H, W], area [B, C, 1, 1]
        bi, ci, yi, xi = inside_mask(e0, e1, e2, area).nonzero(as_tuple=True)
        yield ((bi, ci + m0, yi, xi), e1[bi, ci, yi, xi], e2[bi, ci, yi, xi],
               area[bi, ci, 0, 0])


def loopblinn_batch(
    tris, classes, min_x, max_y, scale, *, height, width, sample_offset=(0.0, 0.0)
):
    """Batched triangle-mesh fill with per-glyph grid anchors.

    - ``tris``: float32 ``[B, M, 3, 4]`` (x y u v per corner)
    - ``classes``: int32 ``[B, M]`` (0 concave, 1 convex, 2 solid, 3 padding)
    - ``min_x``, ``max_y``: int32 ``[B]`` pixel-space anchors
    - ``scale``: pixels per font unit, rounded to float32
    - ``sample_offset``: ``(ox, oy)`` sub-pixel offsets in pixels
    -> bool ``[B, height, width]`` on the triangles' device, row 0 at the top.

    The edge functions run on every (triangle, pixel) pair; the barycentric
    weights and the class test only on the pairs inside, where a triangle
    can draw.
    """
    out = torch.zeros((tris.shape[0], height, width), dtype=torch.bool, device=tris.device)
    for (bi, mi, yi, xi), e1, e2, area in inside_pairs(
            tris, min_x, max_y, scale, height=height, width=width,
            sample_offset=sample_offset):
        keep = class_test(tris[bi, mi], classes[bi, mi], e1, e2, area)
        out[bi[keep], yi[keep], xi[keep]] = True
    return out
