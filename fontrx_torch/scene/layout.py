"""Text layout: code points -> per-instance glyph placements.

A bounded copy of ``fontrx/scene/layout.py``: ``Instance``,
``LazyInstances``, ``TextLayout`` and the default path of ``layout_text``, which is the reference's own
``addChar`` pipeline (``Appli.zig:318-351``) extended to several lines with
the hhea line height. The text is normalized to NFC, each line becomes a
stream of glyph indices, glyphs dedup by index into one packed batch, and
the pen advances by each glyph's advance width in font units, one line
height down per line.

Everything else that the original's ``layout_text`` offers raises
``NotImplementedError``: every non-default option (padding, line height,
kerning, shaping, marks, vertical, wrapping, direction, spacing,
decorations, alignment),
and every character that would leave the plain path there. The accepted
characters are the code points below U+0590 (Latin, Greek, Cyrillic,
Armenian) that are not combining marks and not U+00AD, whose glyph the
font maps or whose canonical decomposition it cannot serve. That range
holds none of the characters the original treats apart: variation
selectors, default-ignorables other than U+00AD and U+034F (a mark),
Arabic, and the scripts it shapes even by default. A font that the
original would run through ``morx`` raises too.
``tests/test_torch_frontend.py`` holds the copy equal to the original.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass

import numpy as np

from fontrx_torch.font.font import Font
from fontrx_torch.pack.segments import PackedBatch, pack_glyphs
from fontrx_torch.scene.transform import Transform

# the first code point past the ported range: Hebrew, then Arabic and the
# scripts the original shapes
PLAIN_LIMIT = 0x0590

# the options of the original's layout_text that are not ported, with
# their defaults
UNPORTED = {
    "pad_batch_to": None, "line_height": None, "kern": False, "ligatures": False,
    "marks": False, "features": None, "vertical": False, "positioning": None,
    "wrap_width": None, "oblique": 0.0,
    "rtl": False, "bidi": False, "alternate": 0, "letter_spacing": 0.0,
    "word_spacing": 0.0, "underline": False, "strikethrough": False,
    "tracking_ptem": None, "aat_features": (), "align": "left", "kashida": False,
}


@dataclass(frozen=True, slots=True)
class Instance:
    """One placed glyph: index into the layout's unique-glyph batch + pen
    offset in font units."""

    glyph_slot: int
    x: float
    y: float

    def local_transform(self) -> Transform:
        return Transform(offset=(self.x, self.y))


class LazyInstances:
    """An array-backed instance sequence: it behaves like ``list[Instance]``
    but holds the columns (slots int32 ``[N]``, offsets float64 ``[N, 2]``),
    so batched consumers skip the objects. The incremental layout's merge
    builds it; ``Instance`` objects are made only when someone indexes or
    iterates."""

    __slots__ = ("slots", "offsets")

    def __init__(self, slots: np.ndarray, offsets: np.ndarray):
        self.slots = slots
        self.offsets = offsets

    def __len__(self) -> int:
        return int(self.slots.shape[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return Instance(int(self.slots[i]), float(self.offsets[i, 0]), float(self.offsets[i, 1]))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


@dataclass(slots=True)
class TextLayout:
    """A laid-out text run over a deduplicated glyph batch."""

    batch: PackedBatch
    slot_chars: list[int]  # code point per unique-glyph slot
    slot_gids: list[int]   # font glyph index per slot
    instances: list[Instance] | LazyInstances
    width: float  # pen extent in font units
    height: float

    def instance_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(slots int32 [N], offsets float32 [N, 2])."""
        li = self.instances
        if isinstance(li, LazyInstances):
            return li.slots, li.offsets.astype(np.float32).reshape(-1, 2)
        slots = np.array([i.glyph_slot for i in li], np.int32)
        offs = np.array([[i.x, i.y] for i in li], np.float32)
        return slots, offs.reshape(-1, 2)


def plain_glyph_index(font: Font, ch: str) -> int:
    """The glyph index of one character of NFC text on the plain path;
    raises ``NotImplementedError`` for a character that would leave it."""
    cp = ord(ch)
    if cp == 0xAD:
        raise NotImplementedError("U+00AD (soft hyphen) is not ported")
    if unicodedata.category(ch).startswith("M"):
        raise NotImplementedError(f"combining mark U+{cp:04X} is not ported")
    if cp >= PLAIN_LIMIT:
        raise NotImplementedError(
            f"U+{cp:04X}: only code points below U+{PLAIN_LIMIT:04X} are ported")
    gid = int(font.charmap.glyph_index(cp))
    if gid == 0:
        parts = unicodedata.normalize("NFD", ch)
        if len(parts) > 1 and all(font.charmap.glyph_index(ord(p)) for p in parts):
            raise NotImplementedError(
                f"U+{cp:04X} is unmapped and its decomposition would be drawn: not ported")
    return gid


def layout_text(font: Font, text: str, **options) -> TextLayout:
    """Lay out ``text`` (lines split at ``\\n``) at the em scale: glyph slots
    dedup by glyph index, instances carry pen offsets in font units, and
    lines are the hhea ascent - descent + line gap apart. The original's
    options are accepted at their defaults only (``UNPORTED``)."""
    for name, value in options.items():
        if name not in UNPORTED:
            raise TypeError(f"layout_text() got an unexpected keyword argument {name!r}")
        if value != UNPORTED[name]:
            raise NotImplementedError(
                f"layout_text({name}={value!r}) is not ported (ROADMAP item 7a)")
    if b"morx" in font.tables and b"GSUB" not in font.tables:
        raise NotImplementedError("a font shaped by its morx table is not ported")

    text = unicodedata.normalize("NFC", text)
    lines: list[list[int]] = [[]]
    for ch in text:
        if ch == "\n":
            lines.append([])
        else:
            lines[-1].append(plain_glyph_index(font, ch))

    # dedup by glyph index; loading a glyph first lets a USE_MY_METRICS
    # compound patch its advance before it is read
    slot_of: dict[int, int] = {}
    glyphs = []
    widths: list[int] = []
    slot_chars: list[int] = []
    for line in lines:
        for gid in line:
            if gid not in slot_of:
                slot_of[gid] = len(glyphs)
                glyphs.append(font.load_glyph(gid))
                widths.append(int(font.advance_widths[gid]))
                c = font.charmap.char_for_glyph(gid)
                slot_chars.append(int(c) if c is not None else -1)

    line_height = font.info.ascent - font.info.descent + font.info.line_gap

    instances: list[Instance] = []
    max_x = 0.0
    for line_no, line in enumerate(lines):
        pen_x = 0.0
        pen_y = -line_no * float(line_height)
        for gid in line:
            slot = slot_of[gid]
            instances.append(Instance(slot, pen_x, pen_y))
            pen_x += float(widths[slot])
            max_x = max(max_x, pen_x)

    batch = pack_glyphs(glyphs, widths)
    return TextLayout(
        batch=batch,
        slot_chars=slot_chars,
        slot_gids=list(slot_of),
        instances=instances,
        width=max_x,
        height=len(lines) * line_height,
    )
