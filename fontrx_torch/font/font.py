"""Font facade: open a TrueType ``glyf`` font and resolve characters to
normalized glyphs.

A copy of the ``glyf`` path of ``fontrx/font/font.py``: the table
directory, head/maxp/hhea/hmtx, the char -> glyph map from the best cmap
subtable (formats 4 and 12), short and long ``loca``, a lazy glyph cache,
and compound glyphs flattened recursively with a cycle guard; and for
colour the ``colr`` and ``cpal`` tables (``fontrx_torch.font.colr``) and the
COLR v0 branch of ``color_paint_tree``. WOFF, CFF, variations, hinting,
shaping, COLR v1, SVG documents and bitmap strikes are left out.
``tests/test_torch_frontend.py`` and ``tests/test_torch_color.py`` hold it
equal to the original.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np

from fontrx_torch.font import ttf
from fontrx_torch.font.colr import ColrTable, CpalTable
from fontrx_torch.font.charmap import CharGlyphMapping
from fontrx_torch.font.glyph import Glyph, from_component, from_simple
from fontrx_torch.font.reader import BigEndianReader, CorruptedFont, ensure_mono_increase

log = logging.getLogger(__name__)


@dataclass(frozen=True, slots=True)
class FontInfo:
    """Rendering metadata of a font."""

    units_per_em: int
    y0_baseline: bool
    loca_format: int
    ascent: int
    descent: int
    line_gap: int


class Font:
    """A parsed TrueType ``glyf`` font with lazy glyph loading."""

    def __init__(self, data: bytes):
        if data[:4] in (b"ttcf", b"wOFF", b"wOF2"):
            raise NotImplementedError(
                f"{data[:4]!r} container: only bare TrueType fonts are read")
        self._reader = BigEndianReader(data)
        self.tables = ttf.parse_table_directory(BigEndianReader(data))
        for tag in ttf.REQUIRED_TABLES:
            if tag not in self.tables:
                raise CorruptedFont(f"missing required table {tag!r}")

        head = ttf.Head.parse(self._at(b"head"))
        maxp = ttf.Maxp.parse(self._at(b"maxp"))
        hhea = ttf.Hhea.parse(self._at(b"hhea"))
        self.head = head
        self.maxp = maxp
        self.hhea = hhea
        self.info = FontInfo(
            units_per_em=head.units_per_em,
            y0_baseline=head.y0_is_baseline,
            loca_format=head.index_to_loc_format,
            ascent=hhea.ascent,
            descent=hhea.descent,
            line_gap=hhea.line_gap,
        )
        self.charmap = self._load_charmap()

        # loca: glyph byte offsets into glyf (short offsets are halved)
        r = self._at(b"loca")
        n = maxp.num_glyphs + 1
        if head.index_to_loc_format == 0:
            self._loca = r.u16_array(n).astype(np.uint32) * 2
        else:
            self._loca = r.u32_array(n)
        ensure_mono_increase(self._loca, "loca")
        self._glyf_offset = self.tables[b"glyf"].offset

        self.advance_widths = ttf.parse_hmtx(
            self._at(b"hmtx"), hhea.num_of_long_hor_metrics, maxp.num_glyphs
        )
        self._glyphs: list[Glyph | None] = [None] * maxp.num_glyphs

    @classmethod
    def open(cls, path: str | os.PathLike) -> "Font":
        """Open and parse a ``.ttf`` file."""
        with open(path, "rb") as f:
            return cls(f.read())

    def _at(self, tag: bytes) -> BigEndianReader:
        return BigEndianReader(self._reader.data, self.tables[tag].offset)

    def _load_charmap(self) -> CharGlyphMapping:
        """The best Unicode subtable first, then any other that parses."""
        r = self._at(b"cmap")
        base = r.pos
        subtables = ttf.parse_cmap_index(r)
        best = ttf.select_best_cmap_subtable(subtables)
        candidates = ([best] if best is not None else []) + [
            s for s in subtables if s is not best
        ]
        last_err: Exception | None = None
        for cand in candidates:
            try:
                sub = ttf.parse_cmap_subtable(
                    BigEndianReader(r.data, base + cand.offset)
                )
            except (NotImplementedError, CorruptedFont) as e:
                last_err = e
                continue
            if cand is not best:
                log.warning(
                    "no usable unicode cmap subtable; falling back to "
                    "platform %d/%d", cand.platform_id,
                    cand.platform_specific_id,
                )
            self.cmap_subtable = sub
            return CharGlyphMapping(sub.collect_range_mappings())
        raise CorruptedFont(
            "no usable unicode cmap subtable"
            + (f" (last error: {last_err})" if last_err else "")
        )

    @property
    def num_glyphs(self) -> int:
        return self.maxp.num_glyphs

    def glyph_index(self, char: int | str) -> int:
        if isinstance(char, str):
            char = ord(char)
        return self.charmap.glyph_index(char)

    def get_glyph(self, char: int | str) -> tuple[Glyph, int]:
        """Resolve a character to ``(glyph, advance_width)``."""
        idx = self.glyph_index(char)
        return self.load_glyph(idx), int(self.advance_widths[idx])

    def load_glyph(self, index: int, _track: tuple[int, ...] = ()) -> Glyph:
        """Load (and cache) a glyph by index, recursing into compound
        components; ``_track`` holds the compound glyphs being loaded, so a
        cycle raises ``CorruptedFont``."""
        if not 0 <= index < self.maxp.num_glyphs:
            raise CorruptedFont(f"glyph index {index} out of range")
        cached = self._glyphs[index]
        if cached is not None:
            return cached
        if index in _track:
            raise CorruptedFont(f"compound glyph cycle at index {index}")

        start, end = int(self._loca[index]), int(self._loca[index + 1])
        if start == end:  # an empty glyph
            glyph = Glyph.empty()
        else:
            r = BigEndianReader(self._reader.data, self._glyf_offset + start)
            desc = ttf.GlyphDescription.parse(r)
            if desc.number_of_contours >= 0:
                glyph = from_simple(desc, ttf.SimpleGlyph.parse(r, desc.number_of_contours))
            else:
                comp = ttf.ComponentGlyph.parse(r)
                resolve = {
                    part.glyph_index: self.load_glyph(part.glyph_index, _track + (index,))
                    for part in comp.parts
                }
                glyph = from_component(desc, comp, resolve)
                if comp.metrics_index is not None:
                    # USE_MY_METRICS: the compound takes the flagged
                    # component's advance
                    src = comp.parts[comp.metrics_index].glyph_index
                    if 0 <= src < len(self.advance_widths) and src != index:
                        self.advance_widths[index] = self.advance_widths[src]
        self._glyphs[index] = glyph
        return glyph

    def load_glyph_safe(self, index: int) -> Glyph:
        """``load_glyph`` for batch pipelines: a glyph that fails to load
        becomes an empty glyph, with a warning, instead of failing the
        batch."""
        try:
            return self.load_glyph(index)
        except (CorruptedFont, NotImplementedError) as e:
            log.warning("glyph %d failed to load (%s); masking as empty",
                        index, e)
            return Glyph.empty()

    @property
    def colr(self) -> ColrTable | None:
        """The COLR v0 layer table, or ``None`` (no table, or one that does
        not parse). A COLR v1 table raises ``NotImplementedError`` (ROADMAP
        item 13b)."""
        if not hasattr(self, "_colr"):
            self._colr = None
            if b"COLR" in self.tables:
                try:
                    self._colr = ColrTable.parse(self._at(b"COLR"))
                except ValueError as e:
                    log.warning("COLR unusable: %s", e)
        return self._colr

    @property
    def cpal(self) -> CpalTable | None:
        """The CPAL palettes, or ``None`` (no table, or one that does not
        parse)."""
        if not hasattr(self, "_cpal"):
            self._cpal = None
            if b"CPAL" in self.tables:
                try:
                    self._cpal = CpalTable.parse(self._at(b"CPAL"))
                except ValueError as e:
                    log.warning("CPAL unusable: %s", e)
        return self._cpal

    def color_paint_tree(self, gid: int, palette: int = 0,
                         foreground: tuple[int, int, int, int] = (0, 0, 0, 255)):
        """``gid``'s palette-resolved COLR v0 render tree, ``("layers",
        [("glyph", layer_gid, ("solid", rgba), None), ...])`` painting bottom
        to top, or ``None`` when the font has no COLR record for it. Where
        the original would turn to the glyph's OT-SVG document instead (a
        font with an ``SVG `` table), this raises ``NotImplementedError``
        (ROADMAP item 13b)."""
        colr, cpal = self.colr, self.cpal
        layers = colr.layers(gid) if colr is not None and cpal is not None else None
        if layers is None:
            if b"SVG " in self.tables:
                raise NotImplementedError(
                    "OT-SVG colour glyphs are not ported (ROADMAP item 13b)")
            return None
        return ("layers", [("glyph", lg, ("solid", cpal.color(palette, pe, foreground)), None)
                           for lg, pe in layers])
