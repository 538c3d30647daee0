"""View and instance transforms.

A copy of ``fontrx/scene/transform.py``, whole; ``tests/test_torch_frontend.py``
holds it equal to the original float for float.

Behavioral equivalent of the reference's ``Transform`` /
``ViewTransform`` (``src/Appli.zig:38-89``): affine scale+offset pairs
in em space mapped to NDC ([-1, 1] both axes, y up), with:

- global scale initialized to ``1 / units_per_em`` and offset
  ``(-0.25, -0.25)`` (``Appli.zig:50-61``),
- combine = local then global, with aspect-ratio division on y applied
  at the end (``combineWith``, ``Appli.zig:63-75``),
- exponential zoom ``1.15**scroll`` about the cursor point
  (``Appli.zig:376-390``),
- drag as NDC deltas (``Appli.zig:392-408``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

ZOOM_FACTOR = 1.15


@dataclass(frozen=True, slots=True)
class Transform:
    """Affine ``p -> p * scale + offset`` (``Appli.zig:38-45``)."""

    scale: tuple[float, float] = (1.0, 1.0)
    offset: tuple[float, float] = (0.0, 0.0)


@dataclass(frozen=True, slots=True)
class ViewTransform:
    """Global em->NDC view with zoom/pan/aspect state."""

    scale: tuple[float, float]
    offset: tuple[float, float]
    aspect_ratio: float

    @classmethod
    def init(cls, units_per_em: int, width: int, height: int) -> "ViewTransform":
        s = 1.0 / units_per_em
        return cls((s, s), (-0.25, -0.25), width / height)

    def combine(self, local: Transform) -> Transform:
        """view ∘ local, y additionally divided by aspect via the
        trailing multiply (``Appli.zig:63-75``)."""
        sx = local.scale[0] * self.scale[0]
        sy = local.scale[1] * self.scale[1] * self.aspect_ratio
        ox = local.offset[0] * self.scale[0] + self.offset[0]
        oy = (local.offset[1] * self.scale[1] + self.offset[1]) * self.aspect_ratio
        return Transform((sx, sy), (ox, oy))

    def apply(self, x: float, y: float) -> tuple[float, float]:
        return (
            x * self.scale[0] + self.offset[0],
            (y * self.scale[1] + self.offset[1]) * self.aspect_ratio,
        )

    def invert(self, x: float, y: float) -> tuple[float, float]:
        """NDC -> em (``undoFrom``, ``Appli.zig:83-88``)."""
        return (
            (x - self.offset[0]) / self.scale[0],
            (y / self.aspect_ratio - self.offset[1]) / self.scale[1],
        )

    # -- interaction -------------------------------------------------------

    def zoomed(self, scroll: float, cursor_ndc: tuple[float, float]) -> "ViewTransform":
        """Exponential zoom about the cursor (``Appli.zig:376-390``)."""
        if scroll == 0:
            return self
        s = ZOOM_FACTOR**scroll
        cx, cy = self.invert(*cursor_ndc)
        return replace(
            self,
            offset=(
                self.offset[0] + self.scale[0] * (1 - s) * cx,
                self.offset[1] + self.scale[1] * (1 - s) * cy,
            ),
            scale=(self.scale[0] * s, self.scale[1] * s),
        )

    def dragged(self, dx_ndc: float, dy_ndc: float) -> "ViewTransform":
        """Pan by an NDC cursor delta (``Appli.zig:392-408``)."""
        return replace(
            self,
            offset=(
                self.offset[0] + dx_ndc,
                self.offset[1] + dy_ndc / self.aspect_ratio,
            ),
        )

    def with_aspect(self, width: int, height: int) -> "ViewTransform":
        return replace(self, aspect_ratio=width / height)
