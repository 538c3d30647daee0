"""Incremental paragraph-cached layout for the interactive edit loop.

A copy of ``fontrx/scene/incremental.py`` (``IncrementalLayoutEngine``:
``layout``, ``consume_dirty_lines``, ``_solo`` and ``_merge``) over the
port's ``layout_text``. An edit costs one changed paragraph, not the whole
text:

- hard-``\\n`` paragraphs lay out independently (``pen_y = -line_no *
  line_height`` is the only coupling between lines);
- each paragraph's solo ``TextLayout`` is cached (LRU, keyed by the
  paragraph's text and the font's variable-axis location);
- the page layout is an exact merge: glyph slots deduped again in
  first-seen paragraph order (the full layout's slot order), the packed
  rows copied, and each instance's ``y`` shifted by its paragraph's first
  line times the line height, which is exact for the hhea line height (an
  integer).

``merge(solo layouts) == layout_text(full text)`` field for field. The
port's ``layout_text`` raises on every option away from its default
(ROADMAP item 7a), so the engine raises there too; the original's gates on
those options (a vertical, decorated or padded layout, a line height that
is not an integer, a variable-axis location) come back with them.
``tests/test_torch_edit.py`` holds the engine equal to the original and to
``layout_text``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from fontrx_torch.pack.segments import SEG_ALIGN, PackedBatch
from fontrx_torch.scene.layout import LazyInstances, TextLayout, layout_text

__all__ = ["IncrementalLayoutEngine"]


class IncrementalLayoutEngine:
    """Paragraph-cached ``layout_text`` with an exact merge: one engine per
    (font, layout options), the contract of repeated ``layout_text(font,
    text, **options)`` calls."""

    _CACHE_SIZE = 512  # solo layouts kept (LRU)

    def __init__(self, font, **options):
        self.font = font
        self.options = dict(options)
        self._cache: OrderedDict[tuple, tuple] = OrderedDict()
        self._seq = 0            # per-entry token (id() reuse is unsafe)
        self._last_spans = None  # [(token, base, n_lines)] of the last layout
        self._prev_spans = None  # the baseline of consume_dirty_lines
        # off: every layout is one whole layout_text call (the A/B switch of
        # the edit probe); the original's option gates return with item 7a
        self._mergeable = True

    def _line_height(self) -> int:
        """The line height ``layout_text`` uses: the static hhea branch of
        the original, since the port's ``Font`` has no variations and its
        ``layout_text`` no ``line_height`` (ROADMAP items 18 and 7a); so
        ``_var_key`` is always ``()``."""
        info = self.font.info
        return info.ascent - info.descent + info.line_gap

    def _var_key(self) -> tuple:
        return ()  # no variable-axis location (ROADMAP item 18)

    def layout(self, text: str) -> TextLayout:
        if not self._mergeable:
            self._last_spans = None
            return layout_text(self.font, text, **self.options)
        vk = self._var_key()
        return self._merge([self._solo(p, vk) for p in text.split("\n")], self._line_height())

    def consume_dirty_lines(self):
        """The visual-line span that the last ``layout`` changed against the
        one before it, half-open ``(l0, l1)``; ``(0, 0)`` if nothing
        changed; ``None`` where it is unknown (the first call, the fallback
        path), meaning everything is dirty. A clean paragraph is the same
        cached solo layout at the same first line; a span covers the old and
        the new lines, so insertions and deletions dirty all they shift.
        Consuming makes the last layout the baseline."""
        prev, cur = self._prev_spans, self._last_spans
        self._prev_spans = cur
        if prev is None or cur is None:
            return None
        lo, hi = None, None

        def mark(a, b):
            nonlocal lo, hi
            lo = a if lo is None else min(lo, a)
            hi = b if hi is None else max(hi, b)

        for k in range(max(len(prev), len(cur))):
            if k >= len(prev):
                mark(cur[k][1], cur[k][1] + cur[k][2])
            elif k >= len(cur):
                mark(prev[k][1], prev[k][1] + prev[k][2])
            elif prev[k] != cur[k]:
                mark(min(prev[k][1], cur[k][1]),
                     max(prev[k][1] + prev[k][2], cur[k][1] + cur[k][2]))
        return (0, 0) if lo is None else (lo, hi)

    def _solo(self, para: str, vk: tuple):
        """The cached (solo layout, slots int32 [N], offsets float64 [N, 2],
        slot gids int64, max gid + 1, token) of one paragraph."""
        key = (para, vk)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            return hit
        lay = layout_text(self.font, para, **self.options)
        n = len(lay.instances)
        slots = np.fromiter((i.glyph_slot for i in lay.instances), np.int32, count=n)
        offs = np.array([[i.x, i.y] for i in lay.instances], np.float64).reshape(-1, 2)
        gids = np.asarray(lay.slot_gids, np.int64).reshape(-1)
        self._seq += 1
        entry = (lay, slots, offs, gids, int(gids.max()) + 1 if len(gids) else 0, self._seq)
        self._cache[key] = entry
        if len(self._cache) > self._CACHE_SIZE:
            self._cache.popitem(last=False)
        return entry

    def _merge(self, solos: list, lh) -> TextLayout:
        flh = float(lh)
        # gid -> merged slot (gids are non-negative: the decoration slots,
        # the only negative ids, never reach the merge)
        table = np.full(max((e[4] for e in solos), default=0), -1, np.int32)
        spans: list[tuple] = []
        slot_gids: list[int] = []
        slot_chars: list[int] = []
        # per merged slot: (padded segment row, count, box, advance)
        rows: list[tuple[np.ndarray, int, np.ndarray, int]] = []
        slot_chunks: list[np.ndarray] = []
        off_chunks: list[np.ndarray] = []
        width = 0.0
        base = 0  # the visual lines before this paragraph
        for lay, pslots, poffs, gids, _mg, token in solos:
            remap = table[gids] if len(gids) else table[:0]
            new = np.nonzero(remap < 0)[0]
            if len(new):
                b = lay.batch
                start = len(slot_gids)
                assigned = np.arange(start, start + len(new), dtype=np.int32)
                table[gids[new]] = assigned
                remap[new] = assigned
                for j in new:
                    j = int(j)
                    slot_gids.append(lay.slot_gids[j])
                    slot_chars.append(lay.slot_chars[j])
                    rows.append((b.segments[j], int(b.seg_counts[j]), b.boxes[j],
                                 int(b.advance_widths[j])))
            slot_chunks.append(remap[pslots] if len(pslots) else pslots)
            if base == 0:
                off_chunks.append(poffs)
            else:
                # base * flh is an exact integer-valued float (flh is the
                # integral hhea height): the full layout's -line_no * line_height pen
                shifted = poffs.copy()
                shifted[:, 1] -= base * flh
                off_chunks.append(shifted)
            width = max(width, lay.width)
            n_lines = int(round(float(lay.height) / flh))
            spans.append((token, base, n_lines))
            base += n_lines
        instances = LazyInstances(np.concatenate(slot_chunks),
                                  np.concatenate(off_chunks).reshape(-1, 2))
        # capacity: the largest solo capacity, which is the full layout's
        # rounded-up largest segment count
        cap = max((r[0].shape[0] for r in rows), default=SEG_ALIGN)
        nb = len(rows)
        segments = np.zeros((nb, cap, 3, 2), dtype=np.float32)
        seg_counts = np.zeros(nb, dtype=np.int32)
        boxes = np.zeros((nb, 4), dtype=np.int32)
        aw = np.zeros(nb, dtype=np.int32)
        for i, (seg, n, box, adv) in enumerate(rows):
            segments[i, : seg.shape[0]] = seg
            seg_counts[i] = n
            boxes[i] = box
            aw[i] = adv
        self._last_spans = spans
        return TextLayout(
            batch=PackedBatch(segments, seg_counts, boxes, aw),
            slot_chars=slot_chars,
            slot_gids=slot_gids,
            instances=instances,
            width=width,
            height=base * lh,
        )
