"""Page rendering: a text layout -> a whole pixel page, in one kernel launch.

The port of the direct path of ``fontrx/scene/page.py::PageRenderer``
(``render_direct``, lines 418-517, ``_compact_instances``, lines 519-554,
and ``to_rgba``, lines 559-577). Every instance's live em-space segments
are concatenated once per layout, with an owning instance per segment; a
frame computes the instances' page-pixel offsets for its view on the host
and rasters the page from that stream with ``kernels.page`` (the CUDA page
kernels on a CUDA device, their plain versions on the CPU): the fill, the
debug gray, a band, or the 2 x 2 MSAA page.

Left out: the shape buckets of the reference's stream (2048 segments) and
offsets (256 instances), which only keep XLA's shapes stable (the one trace
their padding leaves on the page, the padding point in the hull of a last
chunk that is not full, is part of ``kernels.page_ref``'s function);
composite mode (``render``, ``rasterize_glyphs``, ``GlyphTileCache``;
ROADMAP item 8) and ``render_color`` (item 13).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from fontrx_torch.font.font import Font
from fontrx_torch.kernels import page
from fontrx_torch.scene.layout import TextLayout
from fontrx_torch.scene.transform import ViewTransform


@dataclass
class PageRenderer:
    """Renders a ``TextLayout`` under a ``ViewTransform`` to a ``height x
    width`` page on ``device`` (``"cuda"``, ``"cuda:1"``, ``"cpu"`` or a
    ``torch.device``)."""

    font: Font
    layout: TextLayout
    width: int
    height: int
    device: torch.device | str
    _compact_cache: tuple | None = field(default=None, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)

    def page_inputs(self, view: ViewTransform):
        """What the page kernel takes for ``view``: ``(flat_segments
        float32 [S, 3, 2], seg_inst_idx int32 [S], inst_offsets float32
        [N, 2], s_px)``, the tensors on the renderer's device.

        ``s_px`` is ``float32(view.scale[0] * (width / 2))``; each offset is
        the instance's em origin in page pixels, y up (page row ``r``
        samples ``y = height - 1 - r``), computed in float64 and rounded
        once to float32."""
        flat_segments, seg_inst_idx, em = self._compact_instances()
        s_px = np.float32(view.scale[0] * (self.width / 2.0))
        ndc_x = em[:, 0] * view.scale[0] + view.offset[0]
        ndc_y = (em[:, 1] * view.scale[1] + view.offset[1]) * view.aspect_ratio
        xs = np.empty((len(em), 2), np.float32)
        xs[:, 0] = (ndc_x + 1.0) / 2.0 * self.width
        xs[:, 1] = (ndc_y + 1.0) / 2.0 * self.height
        return flat_segments, seg_inst_idx, torch.from_numpy(xs).to(self.device), s_px

    def render_direct(
        self, view: ViewTransform, msaa: bool = False, debug: bool = False,
        band: tuple[int, int] | None = None,
    ) -> torch.Tensor:
        """One frame: uint8 ``[height, width]`` on the renderer's device, the
        0/255 fill, with ``debug`` the winding gray ``clip(w * 20 + 100, 0,
        255)``, or with ``msaa`` (which wins over ``debug``) the 2 x 2 MSAA
        page (0, 63, 127, 191, 255). ``band=(y0, rows)`` renders page rows
        ``[y0, y0 + rows)`` of the fill only, equal to the same rows of the
        whole page at the first view. One launch of a page kernel on a CUDA
        device."""
        y0, rows = (0, self.height) if band is None else band
        if len(self.layout.instances) == 0:
            return torch.zeros((rows, self.width), dtype=torch.uint8, device=self.device)
        if band is not None and (msaa or debug):
            raise ValueError("band renders are fill-only")
        if msaa:
            return page.direct_page_msaa(*self.page_inputs(view), page_h=self.height,
                                         page_w=self.width)
        return page.direct_page(
            *self.page_inputs(view), y0, page_h=self.height, page_w=self.width,
            out_h=rows, mode="gray" if debug else "fill")

    @staticmethod
    def to_rgba(page_u8, transparent: bool = False) -> np.ndarray:
        """A grayscale page (uint8 ``[H, W]``, a tensor or an array) as
        uint8 RGBA ``[H, W, 4]`` on the host: gray in R, G and B, and alpha
        the coverage with ``transparent`` (the reference's
        transparent-framebuffer mode, Ctrl+T), else 255 (opaque over
        black)."""
        if torch.is_tensor(page_u8):
            page_u8 = page_u8.cpu().numpy()
        if page_u8.ndim == 3:
            raise NotImplementedError(
                "to_rgba of an [H, W, 3] colour page: render_color is not ported (ROADMAP "
                "item 13)")
        a = page_u8.astype(np.uint8)
        rgba = np.empty(a.shape + (4,), np.uint8)
        rgba[..., :3] = a[..., None]
        rgba[..., 3] = a if transparent else 255
        return rgba

    def _compact_instances(self):
        """Every instance's live segments concatenated, padding dropped,
        with the owning instance of each, and the instances' em-space pen
        offsets: ``(float32 [S, 3, 2], int32 [S])`` on the renderer's
        device and float64 ``[N, 2]`` on the host, built once per layout
        (the reference rebuilds the offsets every frame)."""
        if self._compact_cache is not None:
            return self._compact_cache
        slots, offsets_em = self.layout.instance_arrays()
        batch = self.layout.batch
        counts = np.asarray(batch.seg_counts)[slots]
        seg = np.concatenate(
            [batch.segments[slot, :n] for slot, n in zip(slots, counts)]
            + [np.zeros((0, 3, 2), np.float32)])
        idx = np.repeat(np.arange(len(slots), dtype=np.int32), counts)
        self._compact_cache = (torch.from_numpy(seg).to(self.device),
                               torch.from_numpy(idx).to(self.device),
                               offsets_em.astype(np.float64))
        return self._compact_cache
