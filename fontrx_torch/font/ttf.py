"""TrueType wire-format structures and parsers for ``glyf`` fonts.

A copy of the parts of ``fontrx/font/ttf.py`` that the port's front end
reads: the table directory, ``head``, ``maxp``, ``hhea`` and ``hmtx``, the
``cmap`` index with its best-subtable choice and cmap formats 4 and 12, and
simple and compound ``glyf`` glyphs. TrueType collections, the other cmap
formats, vertical metrics and kerning are left out: the other formats raise
``NotImplementedError``. ``tests/test_torch_frontend.py`` holds the front
end equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fontrx_torch.font.reader import (
    F2D14,
    BigEndianReader,
    CorruptedFont,
    FixedPoint,
    ensure_mono_increase,
)

# tables a renderable glyf font needs
REQUIRED_TABLES = (b"cmap", b"head", b"hhea", b"hmtx", b"maxp", b"glyf", b"loca")


# --------------------------------------------------------------------------
# Table directory
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class TableEntry:
    tag: bytes
    checksum: int
    offset: int
    length: int


def parse_table_directory(r: BigEndianReader) -> dict[bytes, TableEntry]:
    """Parse the offset subtable and directory into a tag -> entry map."""
    scaler_type, num_tables, _search, _selector, _shift = r.unpack("IHHHH")
    if scaler_type not in (0x00010000, 0x74727565):  # 1.0 and 'true'
        raise CorruptedFont(f"not a TrueType scaler type: {scaler_type:#x}")
    tables: dict[bytes, TableEntry] = {}
    for _ in range(num_tables):
        tag = r.tag()
        checksum, offset, length = r.unpack("III")
        tables[tag] = TableEntry(tag, checksum, offset, length)
    return tables


# --------------------------------------------------------------------------
# head / maxp / hhea / hmtx
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class Head:
    """``head`` table."""

    flags: int
    units_per_em: int
    x_min: int
    y_min: int
    x_max: int
    y_max: int
    mac_style: int
    lowest_rec_ppem: int
    font_direction_hint: int
    index_to_loc_format: int  # 0 = short (u16*2), 1 = long (u32)
    glyph_data_format: int

    MAGIC = 0x5F0F3CF5

    @property
    def y0_is_baseline(self) -> bool:
        """head.flags bit 0: y value of 0 specifies baseline."""
        return bool(self.flags & 1)

    @classmethod
    def parse(cls, r: BigEndianReader) -> "Head":
        _version, _revision, _checksum_adj, magic = r.unpack("IIII")
        if magic != cls.MAGIC:
            raise CorruptedFont(f"bad head magic {magic:#x}")
        flags, units_per_em = r.unpack("HH")
        r.skip(16)  # created + modified longDateTime
        x_min, y_min, x_max, y_max = r.unpack("hhhh")
        mac_style, lowest_rec_ppem, direction, loca_fmt, glyph_fmt = r.unpack("HHhhh")
        return cls(flags, units_per_em, x_min, y_min, x_max, y_max, mac_style,
                   lowest_rec_ppem, direction, loca_fmt, glyph_fmt)


@dataclass(frozen=True, slots=True)
class Maxp:
    """``maxp`` table, version 1.0 (glyf fonts)."""

    num_glyphs: int
    max_points: int
    max_contours: int
    max_component_points: int
    max_component_contours: int
    max_component_elements: int
    max_component_depth: int

    @classmethod
    def parse(cls, r: BigEndianReader) -> "Maxp":
        version = r.u32()
        num_glyphs = r.u16()
        if version < 0x00010000:
            raise CorruptedFont(f"maxp version {version:#x} is not a glyf font's")
        max_points, max_contours, max_cpoints, max_ccontours = r.unpack("HHHH")
        r.skip(2 * 7)  # maxZones .. maxSizeOfInstructions
        max_celems, max_cdepth = r.unpack("HH")
        return cls(num_glyphs, max_points, max_contours, max_cpoints,
                   max_ccontours, max_celems, max_cdepth)


@dataclass(frozen=True, slots=True)
class Hhea:
    """``hhea`` table."""

    ascent: int
    descent: int
    line_gap: int
    advance_width_max: int
    num_of_long_hor_metrics: int

    @classmethod
    def parse(cls, r: BigEndianReader) -> "Hhea":
        _version = r.u32()
        ascent, descent, line_gap, advance_width_max = r.unpack("hhhH")
        r.skip(2 * 3 + 2 * 8)  # minLSB..metricDataFormat (incl. reserved)
        num_metrics = r.u16()
        return cls(ascent, descent, line_gap, advance_width_max, num_metrics)


def parse_hmtx(r: BigEndianReader, num_metrics: int, num_glyphs: int) -> np.ndarray:
    """Advance widths per glyph, uint16 ``[num_glyphs]``; trailing glyphs
    reuse the last long metric's advance."""
    if num_metrics == 0:
        raise CorruptedFont("hmtx: zero long metrics")
    pairs = np.frombuffer(r.data, dtype=">u2", count=2 * num_metrics, offset=r.pos)
    advances = pairs[0::2].astype(np.uint16)
    out = np.empty(num_glyphs, dtype=np.uint16)
    n = min(num_metrics, num_glyphs)
    out[:n] = advances[:n]
    out[n:] = advances[n - 1]
    return out


# --------------------------------------------------------------------------
# cmap
# --------------------------------------------------------------------------

PLATFORM_UNICODE = 0
PLATFORM_MICROSOFT = 3

# Unicode platform-specific ids
UNI_ISO_10646 = 2          # deprecated -> discarded by selection
UNI_2_0_BMP = 3
UNI_2_0_FULL = 4
UNI_VARIATION = 5
UNI_LAST_RESORT = 6
# Microsoft platform-specific ids
MS_UNICODE_BMP = 1
MS_UNICODE_UCS4 = 10


@dataclass(frozen=True, slots=True)
class CmapEncodingSubtable:
    """One cmap encoding record, with the selection rules."""

    platform_id: int
    platform_specific_id: int
    offset: int

    def is_unicode(self) -> bool:
        if self.platform_id == PLATFORM_UNICODE:
            return self.platform_specific_id != UNI_VARIATION
        if self.platform_id == PLATFORM_MICROSOFT:
            return self.platform_specific_id in (MS_UNICODE_BMP, MS_UNICODE_UCS4)
        return False

    def bmp_restriction(self) -> int:
        """0 unknown, 1 restricted to the BMP, 2 full repertoire (bigger is
        better)."""
        if self.platform_id == PLATFORM_UNICODE:
            if self.platform_specific_id == UNI_2_0_BMP:
                return 1
            if self.platform_specific_id in (UNI_2_0_FULL, UNI_LAST_RESORT):
                return 2
            return 0
        if self.platform_id == PLATFORM_MICROSOFT:
            if self.platform_specific_id == MS_UNICODE_BMP:
                return 1
            if self.platform_specific_id == MS_UNICODE_UCS4:
                return 2
            return 0
        return 0

    def is_unicode_discarded(self) -> bool:
        return (self.platform_id == PLATFORM_UNICODE
                and self.platform_specific_id == UNI_ISO_10646)

    def is_the_best(self) -> bool:
        return (self.is_unicode() and not self.is_unicode_discarded()
                and self.bmp_restriction() == 2)

    def is_better_than(self, other: "CmapEncodingSubtable") -> bool:
        if not self.is_unicode():
            return False
        if not other.is_unicode():
            return True
        if self.is_unicode_discarded():
            return False
        if other.is_unicode_discarded():
            return True
        return self.bmp_restriction() >= other.bmp_restriction()


def select_best_cmap_subtable(
    subtables: list[CmapEncodingSubtable],
) -> CmapEncodingSubtable | None:
    """The first full-repertoire Unicode subtable, else the pairwise-better
    survivor; ``None`` when no subtable is Unicode."""
    best: CmapEncodingSubtable | None = None
    for sub in subtables:
        if sub.is_the_best():
            return sub
        if best is None or sub.is_better_than(best):
            best = sub
    if best is not None and not best.is_unicode():
        return None
    return best


def parse_cmap_index(r: BigEndianReader) -> list[CmapEncodingSubtable]:
    _version, count = r.unpack("HH")
    return [CmapEncodingSubtable(*r.unpack("HHI")) for _ in range(count)]


@dataclass(frozen=True, slots=True)
class CmapFormat4:
    """Segment-mapping-to-delta subtable."""

    end_code: np.ndarray       # u16[seg]
    start_code: np.ndarray     # u16[seg]
    id_delta: np.ndarray       # u16[seg] (mod-65536 arithmetic)
    id_range_offset: np.ndarray  # u16[seg]
    glyph_index_array: np.ndarray  # u16[n]

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat4":
        _length, _language, seg_count_x2 = r.unpack("HHH")
        if seg_count_x2 & 1:
            raise CorruptedFont("cmap4: odd segCountX2")
        seg = seg_count_x2 // 2
        r.skip(6)  # searchRange, entrySelector, rangeShift
        end_code = r.u16_array(seg)
        r.skip(2)  # reservedPad
        start_code = r.u16_array(seg)
        id_delta = r.u16_array(seg)
        id_range_offset = r.u16_array(seg)
        ensure_mono_increase(end_code, "cmap4 endCode")
        if seg == 0 or end_code[-1] != 0xFFFF:
            raise CorruptedFont("cmap4: last endCode must be 0xFFFF")
        if np.any(end_code < start_code):
            raise CorruptedFont("cmap4: endCode < startCode")
        if np.any(id_range_offset & 1):
            raise CorruptedFont("cmap4: odd idRangeOffset")

        # the part of glyphIndexArray that the segments reference
        seg_idx = np.arange(seg, dtype=np.int64)
        used = id_range_offset.astype(np.int64) != 0
        max_index = -1
        if np.any(used):
            base = seg_idx + id_range_offset.astype(np.int64) // 2 - seg
            # a base before glyphIndexArray would become a negative index
            if np.any(base[used] < 0):
                raise CorruptedFont(
                    "cmap4: idRangeOffset points before glyphIndexArray"
                )
            idx = base + (
                end_code.astype(np.int64) - start_code.astype(np.int64)
            )
            max_index = int(idx[used].max())
        glyph_index_array = (r.u16_array(max_index + 1) if max_index >= 0
                             else np.empty(0, np.uint16))
        return cls(end_code, start_code, id_delta, id_range_offset, glyph_index_array)

    def collect_range_mappings(self) -> np.ndarray:
        """Flatten to ``(end_char, char_count, end_glyph)`` rows: segments
        through glyphIndexArray become one-char ranges; delta segments that
        wrap past 65535 split at the wrap point (the first half maps to the
        glyph-0 sentinel)."""
        rows: list[tuple[int, int, int]] = []
        seg = len(self.end_code)
        for i in range(seg):
            start = int(self.start_code[i])
            end = int(self.end_code[i])
            delta = int(self.id_delta[i])
            ro = int(self.id_range_offset[i])
            if ro != 0:
                base = i + ro // 2 - seg
                g = self.glyph_index_array[base : base + (end - start + 1)].astype(np.int64)
                for char_offset, glyph in enumerate(g):
                    rows.append((start + char_offset + 1, 1, (delta + int(glyph) + 1) & 0xFFFF))
            else:
                start_glyph = (delta + start) & 0xFFFF
                end_glyph = (delta + end) & 0xFFFF
                if start_glyph > end_glyph:  # wraps through 0xFFFF
                    mid_code = (-start_glyph) & 0xFFFF
                    rows.append((mid_code + 1, mid_code - start + 1, 0))
                    rows.append((end + 1, end - mid_code, (end_glyph + 1) & 0xFFFF))
                else:
                    rows.append((end + 1, end - start + 1, (end_glyph + 1) & 0xFFFF))
        return np.array(rows, dtype=np.int64).reshape(-1, 3)


@dataclass(frozen=True, slots=True)
class CmapFormat12:
    """Segmented-coverage subtable."""

    start_char: np.ndarray  # u32[groups]
    end_char: np.ndarray    # u32[groups]
    start_glyph: np.ndarray  # u32[groups]

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat12":
        r.skip(2)  # reserved (format is 12.0: format u16 already consumed)
        _length, _language, n_groups = r.unpack("III")
        raw = np.frombuffer(r.data, dtype=">u4", count=3 * n_groups, offset=r.pos)
        raw = raw.astype(np.uint32).reshape(-1, 3)
        ensure_mono_increase(raw[:, 0], "cmap12 startCharCode")
        return cls(raw[:, 0].copy(), raw[:, 1].copy(), raw[:, 2].copy())

    def collect_range_mappings(self) -> np.ndarray:
        count = self.end_char.astype(np.int64) - self.start_char.astype(np.int64) + 1
        end_char = self.end_char.astype(np.int64) + 1
        end_glyph = self.start_glyph.astype(np.int64) + count - 1 + 1
        return np.stack([end_char, count, end_glyph], axis=1)


# cmap formats the JAX package parses and this copy does not
UNPORTED_CMAP_FORMATS = (0, 2, 6, 8, 10, 13, 14)


def parse_cmap_subtable(r: BigEndianReader):
    """Dispatch on the format number: 4 and 12 parse; the other defined
    formats raise ``NotImplementedError``, an unknown one ``CorruptedFont``."""
    fmt = r.u16()
    if fmt == 4:
        return CmapFormat4.parse(r)
    if fmt == 12:
        return CmapFormat12.parse(r)
    if fmt in UNPORTED_CMAP_FORMATS:
        raise NotImplementedError(f"cmap format {fmt} not implemented")
    raise CorruptedFont(f"unknown cmap format {fmt}")


# --------------------------------------------------------------------------
# glyf
# --------------------------------------------------------------------------

# Simple-glyph outline flags
FLAG_ON_CURVE = 0x01
FLAG_X_SHORT = 0x02
FLAG_Y_SHORT = 0x04
FLAG_REPEAT = 0x08
FLAG_X_SAME_OR_POS = 0x10
FLAG_Y_SAME_OR_POS = 0x20


@dataclass(frozen=True, slots=True)
class GlyphDescription:
    """Per-glyph header."""

    number_of_contours: int  # >=0 simple, <0 compound
    x_min: int
    y_min: int
    x_max: int
    y_max: int

    @classmethod
    def parse(cls, r: BigEndianReader) -> "GlyphDescription":
        return cls(*r.unpack("hhhhh"))


@dataclass(frozen=True, slots=True)
class SimpleGlyph:
    """Decoded simple glyph: absolute points and on-curve bits."""

    end_pts_of_contours: np.ndarray  # u16[contours]
    instructions: bytes
    on_curve: np.ndarray             # bool[points]
    coordinates: np.ndarray          # i32[points, 2] absolute

    @classmethod
    def parse(cls, r: BigEndianReader, num_contours: int) -> "SimpleGlyph":
        end_pts = r.u16_array(num_contours)
        ensure_mono_increase(end_pts, "endPtsOfContours")
        n_points = int(end_pts[-1]) + 1 if num_contours else 0
        instr_len = r.u16()
        instructions = r.bytes(instr_len)

        # --- flag stream (run-length encoded) ---
        flags = np.empty(n_points, dtype=np.uint8)
        i = 0
        data, pos = r.data, r.pos
        while i < n_points:
            if pos >= len(data):
                raise CorruptedFont("glyf: flag stream truncated")
            f = data[pos]
            pos += 1
            flags[i] = f
            i += 1
            if f & FLAG_REPEAT:
                if pos >= len(data):
                    raise CorruptedFont("glyf: flag repeat truncated")
                rep = data[pos]
                pos += 1
                flags[i : i + rep] = f
                i += rep
        if i != n_points:
            raise CorruptedFont("glyf: flag run overruns point count")
        r.pos = pos

        # --- coordinate streams (vectorized delta decode) ---
        def decode_axis(short_bit: int, same_bit: int) -> np.ndarray:
            short = (flags & short_bit) != 0
            same = (flags & same_bit) != 0
            n_short = int(short.sum())
            n_long = int((~short & ~same).sum())
            nbytes = n_short + 2 * n_long
            raw = np.frombuffer(r.data, dtype=np.uint8, count=nbytes, offset=r.pos)
            r.skip(nbytes)
            deltas = np.zeros(n_points, dtype=np.int32)
            # byte offsets of each point's encoded delta
            size = np.where(short, 1, np.where(same, 0, 2)).astype(np.int64)
            starts = np.concatenate(([0], np.cumsum(size)[:-1]))
            if n_short:
                s_starts = starts[short]
                mag = raw[s_starts].astype(np.int32)
                sign = np.where(same[short], 1, -1)  # same_bit doubles as sign for short
                deltas[short] = mag * sign
            long_mask = ~short & ~same
            if n_long:
                l_starts = starts[long_mask]
                hi = raw[l_starts].astype(np.int32)
                lo = raw[l_starts + 1].astype(np.int32)
                val = (hi << 8) | lo
                val = np.where(val >= 0x8000, val - 0x10000, val)
                deltas[long_mask] = val
            return np.cumsum(deltas, dtype=np.int64).astype(np.int32)

        xs = decode_axis(FLAG_X_SHORT, FLAG_X_SAME_OR_POS)
        ys = decode_axis(FLAG_Y_SHORT, FLAG_Y_SAME_OR_POS)
        coords = np.stack([xs, ys], axis=1)
        return cls(end_pts.astype(np.uint16), instructions,
                   (flags & FLAG_ON_CURVE) != 0, coords)


# Compound-glyph component flags
ARG_1_AND_2_ARE_WORDS = 0x0001
ARGS_ARE_XY_VALUES = 0x0002
ROUND_XY_TO_GRID = 0x0004
WE_HAVE_A_SCALE = 0x0008
MORE_COMPONENTS = 0x0020
WE_HAVE_AN_X_AND_Y_SCALE = 0x0040
WE_HAVE_A_TWO_BY_TWO = 0x0080
WE_HAVE_INSTRUCTIONS = 0x0100
USE_MY_METRICS = 0x0200


@dataclass(frozen=True, slots=True)
class ComponentPart:
    """One component reference inside a compound glyph. ``transform`` is
    the 2.14 matrix (a, b, c, d): x' uses (a, c), y' uses (b, d)."""

    flags: int
    glyph_index: int
    argument1: int  # dx (or point index when not ARGS_ARE_XY_VALUES)
    argument2: int  # dy
    transform: tuple[FixedPoint, FixedPoint, FixedPoint, FixedPoint]

    @property
    def args_are_xy_values(self) -> bool:
        return bool(self.flags & ARGS_ARE_XY_VALUES)

    @property
    def round_xy_to_grid(self) -> bool:
        return bool(self.flags & ROUND_XY_TO_GRID)


@dataclass(frozen=True, slots=True)
class ComponentGlyph:
    parts: tuple[ComponentPart, ...]
    instructions: bytes
    metrics_index: int | None  # component index supplying metrics, if any

    @classmethod
    def parse(cls, r: BigEndianReader) -> "ComponentGlyph":
        parts: list[ComponentPart] = []
        metrics_index: int | None = None
        has_instructions = False
        one = FixedPoint.from_int(1, 14)
        zero = FixedPoint(0, 14)
        while True:
            flags, glyph_index = r.unpack("HH")
            if flags & ARG_1_AND_2_ARE_WORDS:
                arg1, arg2 = r.unpack("hh")
            else:
                arg1, arg2 = r.unpack("bb") if flags & ARGS_ARE_XY_VALUES else r.unpack("BB")
            if flags & WE_HAVE_A_SCALE:
                s = F2D14(r.u16())
                transform = (s, zero, zero, s)
            elif flags & WE_HAVE_AN_X_AND_Y_SCALE:
                sx, sy = F2D14(r.u16()), F2D14(r.u16())
                transform = (sx, zero, zero, sy)
            elif flags & WE_HAVE_A_TWO_BY_TWO:
                a, b, c, d = (F2D14(r.u16()) for _ in range(4))
                transform = (a, b, c, d)
            else:
                transform = (one, zero, zero, one)
            parts.append(ComponentPart(flags, glyph_index, arg1, arg2, transform))
            # the spec allows one USE_MY_METRICS part; fonts may set several:
            # the first wins
            if flags & USE_MY_METRICS and metrics_index is None:
                metrics_index = len(parts) - 1
            if flags & WE_HAVE_INSTRUCTIONS:
                has_instructions = True
            if not flags & MORE_COMPONENTS:
                break
        instructions = r.bytes(r.u16()) if has_instructions else b""
        return cls(tuple(parts), instructions, metrics_index)
