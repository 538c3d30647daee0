"""UAX#29 extended grapheme cluster segmentation (Unicode 15.0).

A copy of ``fontrx/font/uax29.py`` (``gcb_class``, ``cluster_breaks``,
``cluster_positions``, ``grapheme_clusters``): rules GB1-GB13 and GB999 over
the class tables of ``fontrx_torch.font._uax29_data``. The interactive
session's ``backspace`` deletes whole clusters with it: a base and its
combining marks, a Hangul syllable's jamo, an emoji ZWJ sequence or a flag
pair. ``tests/test_torch_edit.py`` holds it equal to the original.
"""

from __future__ import annotations

from bisect import bisect_right
from functools import lru_cache

from fontrx_torch.font._uax29_data import (
    CLASSES,
    EXTPICT,
    GCB_IDS,
    GCB_STARTS,
)


@lru_cache(maxsize=8192)
def gcb_class(cp: int) -> str:
    """Grapheme_Cluster_Break class of a codepoint."""
    if cp < 0 or cp > 0x10FFFF:
        return "XX"
    return CLASSES[GCB_IDS[bisect_right(GCB_STARTS, cp) - 1]]


@lru_cache(maxsize=4096)
def _extpict(cp: int) -> bool:
    for lo, hi in EXTPICT:
        if lo <= cp <= hi:
            return True
        if cp < lo:
            return False
    return False


def cluster_breaks(cps: list[int]) -> list[bool]:
    """``brk[i]`` — a grapheme cluster boundary lies BEFORE codepoint
    ``i`` (``brk[0]`` is always False; sot/eot are implicit)."""
    n = len(cps)
    if n == 0:
        return []
    cls = [gcb_class(c) for c in cps]

    def decide(i: int) -> bool:
        pc, qc = cls[i - 1], cls[i]
        # GB3/GB4/GB5
        if pc == "CR" and qc == "LF":
            return False
        if pc in ("CN", "CR", "LF"):
            return True
        if qc in ("CN", "CR", "LF"):
            return True
        # GB6/GB7/GB8 (Hangul)
        if pc == "L" and qc in ("L", "V", "LV", "LVT"):
            return False
        if pc in ("LV", "V") and qc in ("V", "T"):
            return False
        if pc in ("LVT", "T") and qc == "T":
            return False
        # GB9/GB9a/GB9b
        if qc in ("EX", "ZWJ", "SM"):
            return False
        if pc == "PP":
            return False
        # GB11: ExtPict Extend* ZWJ x ExtPict
        if pc == "ZWJ" and _extpict(cps[i]):
            j = i - 2
            while j >= 0 and cls[j] == "EX":
                j -= 1
            if j >= 0 and _extpict(cps[j]):
                return False
        # GB12/GB13: RI pairs
        if pc == "RI" and qc == "RI":
            run = 0
            j = i - 1
            while j >= 0 and cls[j] == "RI":
                run += 1
                j -= 1
            return run % 2 == 0
        # GB999
        return True

    brk = [False] * n
    for i in range(1, n):
        brk[i] = decide(i)
    return brk


def cluster_positions(text: str) -> list[int]:
    """Character offsets where a new cluster starts (the ICU ubrk
    convention, minus ICU's 0 and end-of-text)."""
    cps = [ord(c) for c in text]
    brk = cluster_breaks(cps)
    return [i for i in range(1, len(cps)) if brk[i]]


def grapheme_clusters(text: str) -> list[str]:
    """Split ``text`` into extended grapheme clusters."""
    if not text:
        return []
    cps = [ord(c) for c in text]
    brk = cluster_breaks(cps)
    out = []
    start = 0
    for i in range(1, len(cps)):
        if brk[i]:
            out.append(text[start:i])
            start = i
    out.append(text[start:])
    return out
