"""Character -> glyph-index mapping.

A copy of ``fontrx/font/charmap.py``: a sorted table of ranges
``(end_char, char_count, end_glyph[, stride])`` queried with
``np.searchsorted``, with glyph 0 for unmapped characters. ``end_glyph`` is
stored +1 so that 0 marks "explicitly unmapped"; ``end_char`` is exclusive.
``tests/test_torch_frontend.py`` holds it equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fontrx_torch.font.reader import CorruptedFont, ensure_mono_increase


@dataclass(frozen=True, slots=True)
class RangeMapping:
    """One contiguous char range mapping to a contiguous glyph range.
    ``stride`` 1: the glyph index advances with the char; 0: every char of
    the range maps to the same glyph."""

    end_char: int    # exclusive end of the char range
    char_count: int  # number of chars in the range
    end_glyph: int   # glyph index of the last char, +1 (0 = unmapped)
    stride: int = 1  # 1 = consecutive glyphs, 0 = constant glyph


class CharGlyphMapping:
    """Vectorized range-mapping lookup table."""

    def __init__(self, rows: np.ndarray):
        """``rows`` is ``int64 [n, 3]`` of (end_char, char_count,
        end_glyph) or ``[n, 4]`` with a trailing stride column."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim != 2 or rows.shape[1] not in (3, 4):
            rows = rows.reshape(-1, 3)
        ensure_mono_increase(rows[:, 0], "charmap end_char")
        if np.any(rows[:, 1] <= 0):
            raise CorruptedFont("charmap range with non-positive char_count")
        self.end_char = rows[:, 0].copy()
        self.char_count = rows[:, 1].copy()
        self.end_glyph = rows[:, 2].copy()
        if rows.shape[1] == 4:
            if np.any((rows[:, 3] != 0) & (rows[:, 3] != 1)):
                raise CorruptedFont("charmap stride must be 0 or 1")
            self.stride = rows[:, 3].copy()
        else:
            self.stride = np.ones(len(rows), dtype=np.int64)

    def __len__(self) -> int:
        return len(self.end_char)

    @property
    def ranges(self) -> list[RangeMapping]:
        return [RangeMapping(int(e), int(c), int(g), int(s))
                for e, c, g, s in zip(self.end_char, self.char_count,
                                      self.end_glyph, self.stride)]

    def glyph_index(self, char: int) -> int:
        """Single lookup; 0 when unmapped. Memoized: text repeats few
        unique code points."""
        memo = getattr(self, "_gid_memo", None)
        if memo is None:
            memo = self._gid_memo = {}
        c = int(char)
        v = memo.get(c)
        if v is None:
            v = memo[c] = int(self.glyph_indices(np.array([c]))[0])
        return v

    def glyph_indices(self, chars: np.ndarray) -> np.ndarray:
        """Vectorized lookup of a whole code-point array."""
        chars = np.asarray(chars, dtype=np.int64)
        # the first range whose exclusive end exceeds the char
        idx = np.searchsorted(self.end_char, chars, side="right")
        in_table = idx < len(self.end_char)
        safe = np.where(in_table, idx, 0)
        start_char = self.end_char[safe] - self.char_count[safe]
        in_range = in_table & (chars >= start_char)
        offset_from_end = self.end_char[safe] - 1 - chars
        glyph = self.end_glyph[safe] - 1 - offset_from_end * self.stride[safe]
        glyph = np.where(in_range & (self.end_glyph[safe] != 0), glyph, 0)
        # end_glyph stores +1; unwrap, clamping explicit-unmapped to 0
        return np.maximum(glyph, 0)

    def char_for_glyph(self, glyph_index: int) -> int | None:
        """Reverse linear scan: the first char that maps to ``glyph_index``."""
        for e, c, g, s in zip(self.end_char, self.char_count,
                              self.end_glyph, self.stride):
            if g == 0:
                continue
            last_glyph = g - 1
            first_glyph = last_glyph - (c - 1) * s
            if first_glyph <= glyph_index <= last_glyph:
                if s == 0:  # constant range: report its first char
                    return int(e - c)
                return int(e - 1 - (last_glyph - glyph_index))
        return None
