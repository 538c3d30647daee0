"""Plain PyTorch k x k coverage: the reference for the CUDA coverage kernel.

The port of ``fontrx.kernels.coverage.coverage_batch``: the k² sub-pixel
passes of ``winding_ref.winding_batch`` at the offsets of
``sample_offsets(k)``, each pass's ``(w != 0)`` counted in int32, then the
count cast to float32 and multiplied once by the float32 reciprocal
``np.float32(1 / (k*k))``. That is what both JAX routes compute: the Pallas
kernel multiplies by ``f32(1/k²)`` and jnp's mean of k² {0, 1} rows rounds
the same way. A correctly rounded ``count / k²`` differs from it at some
counts for k = 5, 6 and 7. ``.mean()`` is never called: its rounding
differs between PyTorch's CPU and CUDA builds.
"""

from __future__ import annotations

import numpy as np
import torch

from fontrx_torch.kernels import winding_ref


def sample_offsets(k: int) -> np.ndarray:
    """Centered k x k sub-pixel lattice, float32 ``[k*k, 2]`` of (ox, oy),
    ox varying fastest: ``o_i = (i + 0.5) / k - 0.5`` in float32."""
    o = (np.arange(k, dtype=np.float32) + np.float32(0.5)) / np.float32(k) - np.float32(0.5)
    ox, oy = np.meshgrid(o, o)
    return np.stack([ox.ravel(), oy.ravel()], axis=1)


def inv_samples(k: int) -> np.float32:
    """The float32 reciprocal of the sample count, ``np.float32(1 / (k*k))``."""
    return np.float32(1 / (k * k))


def coverage_batch(segments, min_x, max_y, scale, *, height, width, samples=2):
    """Batched k x k supersampled coverage, k = ``samples``.

    Same inputs as ``winding_ref.winding_batch`` -> float32
    ``[B, height, width]`` in [0, 1] on the segments' device.
    """
    if samples < 1:
        raise ValueError(f"samples must be >= 1, got {samples}")
    b = segments.shape[0]
    count = torch.zeros((b, height, width), dtype=torch.int32, device=segments.device)
    for ox, oy in sample_offsets(samples):
        w = winding_ref.winding_batch(
            segments, min_x, max_y, scale, height=height, width=width,
            sample_offset=(float(ox), float(oy)),
        )
        count += (w != 0).to(torch.int32)
    inv = torch.tensor(inv_samples(samples), dtype=torch.float32, device=segments.device)
    return count.to(torch.float32) * inv


def coverage_to_gray(coverage: torch.Tensor) -> torch.Tensor:
    """Antialiased 8-bit alpha: ``clip(round(coverage * 255), 0, 255)``."""
    return torch.clamp(torch.round(coverage * 255.0), 0, 255).to(torch.uint8)
