"""The plain PyTorch version of the roofline probe's four op mixes.

``tools/tpu_probes/tpu_roofline.py:122-138`` applies one op ``iters`` times
to every element, each application depending on the last. Here each mix is
a step on a tensor, in the reference's order and types: the constants are
float32 (or int16 for the i16 mix), and each product and each sum rounds to
float32 on its own (multiply, round, add, round). The reference's inputs
are ``full(1.000001)`` for the float mixes and ``ones`` for the integer
mixes (``:74-75``): ``initial``.
"""

from __future__ import annotations

import torch

# mix -> (dtype, operations counted per application, tpu_roofline.py:122-138;
# the third mix's comment there says 2, its code passes 3)
MIXES = {
    "f32_mul_add": (torch.float32, 2),
    "i32_add": (torch.int32, 1),
    "i16_add": (torch.int16, 1),
    "f32_cmp_select_add": (torch.float32, 3),
}


def initial(mix, shape, device=None) -> torch.Tensor:
    """The reference's input: 1.000001 (float32) or 1 in the mix's type."""
    dtype = MIXES[mix][0]
    if dtype == torch.float32:
        return torch.full(shape, 1.000001, dtype=dtype, device=device)
    return torch.ones(shape, dtype=dtype, device=device)


def _step(mix, device):
    """One application of ``mix``, in place, with its constants on ``device``."""
    def const(value, dtype=torch.float32):
        return torch.tensor(value, dtype=dtype, device=device)

    if mix == "f32_mul_add":
        a, b = const(1.000001), const(1e-7)
        return lambda x: x.mul_(a).add_(b)
    if mix in ("i32_add", "i16_add"):
        three = const(3, MIXES[mix][0])
        return lambda x: x.add_(three)
    if mix == "f32_cmp_select_add":
        half, up, down = const(0.5), const(1e-7), const(-1e-7)
        return lambda x: x.add_(torch.where(x >= half, up, down))
    raise ValueError(f"unknown mix {mix!r}; expected one of {sorted(MIXES)}")


def elementwise(mix, x, iters) -> torch.Tensor:
    """``iters`` dependent applications of ``mix`` to every element of ``x``
    (the mix's dtype); a new tensor."""
    step = _step(mix, x.device)
    if x.dtype != MIXES[mix][0]:
        raise TypeError(f"{mix} takes {MIXES[mix][0]}, got {x.dtype}")
    y = x.clone()
    for _ in range(iters):
        step(y)
    return y
