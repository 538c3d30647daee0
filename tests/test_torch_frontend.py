"""The port's copies of the host front end against the JAX package's
originals, on the CPU: fonts (both shipped fonts and hand-built ones),
segment packing, raster grids, QOI and the oracle.

The port copies these modules and never imports ``fontrx``; each copy must
give the original's results array for array.
"""

import pathlib

import numpy as np
import pytest

from fontrx.engine.atlas import pack_charset as ref_pack_charset
from fontrx.font import ttf as ref_ttf
from fontrx.font.font import Font as RefFont
from fontrx.io import qoi as ref_qoi
from fontrx.kernels import oracle as ref_oracle
from fontrx.kernels.grid import RasterGrid as RefGrid
from fontrx.pack import segments as ref_segments
from fontrx.scene import layout as ref_layout
from fontrx.scene import transform as ref_transform
from fontrx_torch.engine.atlas import pack_charset
from fontrx_torch.font import ttf
from fontrx_torch.font.font import Font
from fontrx_torch.font.reader import BigEndianReader, CorruptedFont
from fontrx_torch.io import qoi
from fontrx_torch.kernels import oracle
from fontrx_torch.kernels.grid import RasterGrid
from fontrx_torch.pack import segments
from fontrx_torch.scene import layout, transform
from tests import ttf_builder as tb

ROOT = pathlib.Path(__file__).resolve().parents[1]
FONTS = {
    "dejavu": ROOT / "fontrx_torch" / "data" / "DejaVuSans.ttf",
    "cjk": ROOT / "tests" / "data" / "cjktest.ttf",
}
# the code points of the two atlases chip_smoke.py drives, and Latin-1
# accents (compound glyphs in DejaVu Sans)
CHARS = {
    "dejavu": list(range(33, 127)) + [ord(c) for c in "éàüÅß·ﬁ€ñÇŽ"],
    "cjk": [0x4E00 + i for i in range(1024)],
}
CHUNKS = 4


@pytest.fixture(scope="module")
def fonts():
    return {name: (Font.open(path), RefFont.open(str(path))) for name, path in FONTS.items()}


def glyph_fields(font, code):
    glyph, advance = font.get_glyph(code)
    box = (glyph.box.x_min, glyph.box.y_min, glyph.box.x_max, glyph.box.y_max)
    return font.glyph_index(code), advance, box


class TestFont:
    @pytest.mark.parametrize("chunk", range(CHUNKS))
    @pytest.mark.parametrize("name", sorted(FONTS))
    def test_glyphs_equal_reference(self, fonts, name, chunk):
        port, ref = fonts[name]
        codes = CHARS[name][chunk::CHUNKS]
        for code in codes:
            assert glyph_fields(port, code) == glyph_fields(ref, code), hex(code)
            np.testing.assert_array_equal(
                segments.glyph_segments(port.get_glyph(code)[0]),
                ref_segments.glyph_segments(ref.get_glyph(code)[0]), err_msg=hex(code))

    @pytest.mark.parametrize("name", sorted(FONTS))
    def test_font_info_and_tables(self, fonts, name):
        port, ref = fonts[name]
        for field in ref.info.__dataclass_fields__:
            assert getattr(port.info, field) == getattr(ref.info, field), field
        assert port.num_glyphs == ref.num_glyphs
        assert type(port.cmap_subtable).__name__ == type(ref.cmap_subtable).__name__
        np.testing.assert_array_equal(port._loca, ref._loca)
        for attr in ("end_char", "char_count", "end_glyph", "stride"):
            np.testing.assert_array_equal(getattr(port.charmap, attr),
                                          getattr(ref.charmap, attr))

    def test_shipped_fonts_use_cmap_formats_12_and_4(self, fonts):
        assert isinstance(fonts["dejavu"][0].cmap_subtable, ttf.CmapFormat12)
        assert isinstance(fonts["cjk"][0].cmap_subtable, ttf.CmapFormat4)

    @pytest.mark.parametrize("char", list("éÄñÇŽ"))
    def test_dejavu_compound_glyph(self, fonts, char):
        port, ref = fonts["dejavu"]
        index = port.glyph_index(char)
        start = int(port._loca[index])
        r = BigEndianReader(port._reader.data, port._glyf_offset + start)
        assert ttf.GlyphDescription.parse(r).number_of_contours < 0  # compound
        glyph = port.load_glyph(index)
        assert len(glyph.contours) >= 2
        np.testing.assert_array_equal(
            segments.glyph_segments(glyph),
            ref_segments.glyph_segments(ref.load_glyph(index)))

    def test_unmapped_and_out_of_range(self, fonts):
        port, ref = fonts["dejavu"]
        assert port.glyph_index(0x10FFFF) == ref.glyph_index(0x10FFFF) == 0
        with pytest.raises(CorruptedFont, match="out of range"):
            port.load_glyph(port.num_glyphs)
        assert port.load_glyph_safe(port.num_glyphs).num_segments == 0


def square(size=100):
    pts = [(0, 0, True), (0, size, True), (size, size, True), (size, 0, True)]
    return tb.build_simple_glyph([pts], box=(0, 0, size, size))


def curvy():
    pts = [(0, 0, True), (30, 90, False), (60, 100, False), (100, 0, True), (50, -40, False)]
    return tb.build_simple_glyph([pts, [(10, 10, False), (20, 10, False), (15, 20, False)]],
                                 box=(0, -40, 100, 100), use_repeat=True)


HAND_BUILT = {
    "format4_delta": dict(cmap=[(3, 1, tb.build_cmap_format4([(65, 67, -64, None)]))]),
    "format4_array": dict(cmap=[(3, 1, tb.build_cmap_format4([(65, 67, 0, [2, 1, 3])]))]),
    "format12": dict(cmap=[(3, 10, tb.build_cmap_format12([(65, 67, 1)]))]),
    "long_loca": dict(cmap=[(3, 1, tb.build_cmap_format4([(65, 67, -64, None)]))],
                      loca_format=1),
}
COMPOUND_PARTS = {
    "translate": dict(dx=10, dy=-20),
    "scale": dict(dx=3, dy=4, scale=0.5),
    "xy_scale": dict(dx=0, dy=0, xy_scale=(1.5, -0.75)),
    "rotate": dict(dx=7, dy=0, matrix=(0.0, 1.0, -1.0, 0.0)),
    "round": dict(dx=5, dy=5, scale=0.3, round_to_grid=True),
}


def assert_fonts_equal(blob, codes):
    port, ref = Font(blob), RefFont(blob)
    for code in codes:
        assert glyph_fields(port, code) == glyph_fields(ref, code)
        np.testing.assert_array_equal(
            segments.glyph_segments(port.get_glyph(code)[0]),
            ref_segments.glyph_segments(ref.get_glyph(code)[0]))


class TestHandBuiltFonts:
    @pytest.mark.parametrize("case", sorted(HAND_BUILT))
    def test_cmap_and_loca(self, case):
        kw = dict(HAND_BUILT[case])
        cmap = tb.build_cmap(kw.pop("cmap"))
        blob = tb.build_font([b"", square(), curvy(), square(300)], cmap,
                             metrics=[(500, 0), (600, 1), (700, 2), (800, 3)], **kw)
        assert_fonts_equal(blob, [64, 65, 66, 67, 68])

    @pytest.mark.parametrize("case", sorted(COMPOUND_PARTS))
    def test_compound(self, case):
        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4([(65, 67, -64, None)]))])
        parts = [dict(glyph_index=2, **COMPOUND_PARTS[case]),
                 dict(glyph_index=1, dx=100, dy=0)]
        compound = tb.build_compound_glyph(parts, box=(-200, -200, 300, 300))
        blob = tb.build_font([b"", square(), curvy(), compound], cmap)
        assert_fonts_equal(blob, [65, 66, 67])

    def test_cycle_guard(self):
        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4([(65, 65, -64, None)]))])
        self_ref = tb.build_compound_glyph([dict(glyph_index=1, dx=0, dy=0)])
        font = Font(tb.build_font([b"", self_ref], cmap))
        with pytest.raises(CorruptedFont, match="cycle"):
            font.load_glyph(1)
        assert font.load_glyph_safe(1).num_segments == 0

    @pytest.mark.parametrize("fmt", [0, 2, 6, 8, 10, 13, 14])
    def test_unported_cmap_format_raises(self, fmt):
        blob = bytes([0, fmt]) + b"\x00" * 32
        with pytest.raises(NotImplementedError, match=f"cmap format {fmt}"):
            ttf.parse_cmap_subtable(BigEndianReader(blob))

    def test_unknown_cmap_format_raises(self):
        with pytest.raises(CorruptedFont, match="unknown cmap format"):
            ttf.parse_cmap_subtable(BigEndianReader(bytes([0, 99]) + b"\x00" * 8))

    def test_font_with_only_an_unported_cmap_raises(self):
        ids = [0] * 256
        ids[65] = 1
        cmap = tb.build_cmap([(1, 0, tb.build_cmap_format0(ids))])
        blob = tb.build_font([b"", square()], cmap)
        assert RefFont(blob).glyph_index("A") == 1  # the original reads format 0
        with pytest.raises(CorruptedFont, match="no usable unicode cmap"):
            Font(blob)

    @pytest.mark.parametrize("magic", [b"ttcf", b"wOFF", b"wOF2"])
    def test_containers_raise(self, magic):
        with pytest.raises(NotImplementedError):
            Font(magic + b"\x00" * 64)

    def test_not_truetype_raises(self):
        with pytest.raises(CorruptedFont):
            Font(b"OTTO" + b"\x00" * 100)

    def test_best_subtable_choice_equals_reference(self):
        recs = [(0, 3, 44), (0, 4, 100), (1, 0, 200), (3, 1, 44), (3, 10, 100)]
        for order in (recs, recs[::-1], recs[:1] + recs[2:4], recs[2:3]):
            port = ttf.select_best_cmap_subtable(
                [ttf.CmapEncodingSubtable(*r) for r in order])
            ref = ref_ttf.select_best_cmap_subtable(
                [ref_ttf.CmapEncodingSubtable(*r) for r in order])
            assert (port is None) == (ref is None)
            if port is not None:
                assert (port.platform_id, port.platform_specific_id, port.offset) == (
                    ref.platform_id, ref.platform_specific_id, ref.offset)


class TestPacking:
    @pytest.mark.parametrize("use_native", [True, False])
    @pytest.mark.parametrize("name", sorted(FONTS))
    def test_pack_charset_equals_reference(self, name, use_native):
        port = pack_charset(Font.open(FONTS[name]), CHARS[name])
        ref = ref_pack_charset(RefFont.open(str(FONTS[name])), CHARS[name],
                               use_native=use_native)
        for field in ("segments", "seg_counts", "boxes", "advance_widths"):
            a, b = getattr(port, field), getattr(ref, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)

    @pytest.mark.parametrize("kw", [dict(), dict(capacity=256), dict(pad_batch_to=9),
                                    dict(sort="x"), dict(advance_widths=range(5))])
    def test_pack_glyphs_equals_reference(self, fonts, kw):
        port_font, ref_font = fonts["dejavu"]
        chars = "Ag@é&"
        port = segments.pack_glyphs([port_font.get_glyph(c)[0] for c in chars], **kw)
        ref = ref_segments.pack_glyphs([ref_font.get_glyph(c)[0] for c in chars], **kw)
        for field in ("segments", "seg_counts", "boxes", "advance_widths"):
            np.testing.assert_array_equal(getattr(port, field), getattr(ref, field))

    @pytest.mark.parametrize("char", list("AQ@ .é"))
    def test_pack_glyph_equals_reference(self, fonts, char):
        port_font, ref_font = fonts["dejavu"]
        port = segments.pack_glyph(port_font.get_glyph(char)[0])
        ref = ref_segments.pack_glyph(ref_font.get_glyph(char)[0])
        np.testing.assert_array_equal(port.segments, ref.segments)
        assert (port.seg_count, port.box, port.capacity) == (ref.seg_count, ref.box, ref.capacity)

    def test_capacity_overflow_raises(self, fonts):
        with pytest.raises(ValueError, match="capacity"):
            segments.pack_glyph(fonts["dejavu"][0].get_glyph("@")[0], capacity=4)


class TestGrid:
    @pytest.mark.parametrize("box,size,upem", [
        ((0, 0, 1000, 1000), 64, 2048), ((-123, -456, 1789, 1501), 256, 2048),
        ((37, -5, 41, 13), 13, 1000), ((0, 0, 0, 0), 40, 2048),
    ])
    def test_fields_equal_reference(self, box, size, upem):
        for port, ref in (
            (RasterGrid.for_glyph_box(box, size, upem), RefGrid.for_glyph_box(box, size, upem)),
            (RasterGrid.fixed_tile(box, size, upem, 48), RefGrid.fixed_tile(box, size, upem, 48)),
            (RasterGrid.for_glyph_box(box, size, upem).padded(128, 8),
             RefGrid.for_glyph_box(box, size, upem).padded(128, 8)),
        ):
            for field in ("width", "height", "min_x", "max_y", "scale"):
                assert getattr(port, field) == getattr(ref, field), field
            for a, b in zip(port.sample_coords(), ref.sample_coords()):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)


class TestQoi:
    @pytest.mark.parametrize("seed", range(3))
    def test_encode_equals_reference(self, seed):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (23, 31, 3)).astype(np.uint8)
        img[5:9] = img[4]               # runs
        img[12, :, :] = img[11] + 1     # DIFF ops
        img[14, :, 1] = img[13, :, 1] + 20  # LUMA ops
        data = qoi.encode_rgb(img)
        assert data == ref_qoi._encode_rgb_py(img) == ref_qoi.encode_rgb(img)
        np.testing.assert_array_equal(qoi.decode(data), img)

    def test_fill_round_trip(self, fonts):
        glyph = fonts["dejavu"][0].get_glyph("A")[0]
        packed = segments.pack_glyph(glyph)
        grid = RasterGrid.for_glyph_box(packed.box, 48, 2048)
        fill = oracle.render_fill(packed.segments, grid)
        rgb = np.repeat(fill[:, :, None], 3, axis=2)
        data = qoi.encode_rgb(rgb)
        assert data == ref_qoi.encode_rgb(rgb)
        np.testing.assert_array_equal(qoi.decode(data), rgb)
        np.testing.assert_array_equal(ref_qoi.decode(data), rgb)

    @pytest.mark.parametrize("seed", range(3))
    def test_encode_rgba_equals_reference(self, seed):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (19, 27, 4)).astype(np.uint8)
        img[3:6] = img[2]                    # runs
        img[8, :, :3] = img[7, :, :3] + 1    # DIFF ops (alpha unchanged)
        img[8, :, 3] = img[7, :, 3]
        img[10] = img[9]
        img[10, :, 1] += 20                  # LUMA ops
        img[12, ::2, 3] = 0                  # alpha changes: RGBA ops
        img[15] = img[5]                     # index ops
        data = qoi.encode_rgba(img)
        assert data == ref_qoi.encode_rgba(img)
        np.testing.assert_array_equal(qoi.decode(data), img)
        np.testing.assert_array_equal(ref_qoi.decode(data), img)
        assert qoi.encode_rgba(img[:0]) == ref_qoi.encode_rgba(img[:0])

    def test_black_after_gray_round_trips(self):
        """``encode_rgb`` sends a black pixel that no run or DIFF reaches as
        an index op into the zero-filled table (alpha 0), as the original
        does; ``decode`` keeps alpha 255 in an RGB file, so the index ops
        after it read what was written. The original's decoder takes the
        table's alpha and reads this row wrong (``ROADMAP.md`` queue 3)."""
        row = np.array([255, 43, 0, 28, 250, 255], np.uint8)
        img = np.repeat(row[None, :, None], 3, axis=2)
        data = qoi.encode_rgb(img)
        assert data == ref_qoi.encode_rgb(img)
        np.testing.assert_array_equal(qoi.decode(data), img)
        assert ref_qoi.decode(data)[0, -1, 0] == 250
        np.testing.assert_array_equal(qoi.decode(data, strict=True), ref_qoi.decode(data))

    def test_empty_and_bad_input(self):
        empty = np.zeros((0, 4, 3), np.uint8)
        assert qoi.encode_rgb(empty) == ref_qoi._encode_rgb_py(empty)
        with pytest.raises(ValueError, match="not a QOI"):
            qoi.decode(b"png?" + b"\x00" * 20)


class TestOracle:
    @pytest.mark.parametrize("contract", [False, True])
    @pytest.mark.parametrize("char", list("Bg&é"))
    def test_winding_at_equals_reference(self, fonts, char, contract):
        glyph = fonts["dejavu"][0].get_glyph(char)[0]
        segs = segments.glyph_segments(glyph)
        grid = RasterGrid.for_glyph_box(
            (glyph.box.x_min, glyph.box.y_min, glyph.box.x_max, glyph.box.y_max), 40, 2048)
        xs, ys = grid.sample_coords()
        np.testing.assert_array_equal(
            oracle.winding_at(segs, xs[None, :], ys[:, None], contract=contract),
            ref_oracle.winding_at(segs, xs[None, :], ys[:, None], contract=contract))
        np.testing.assert_array_equal(
            oracle.winding_map(segs, grid, contract=contract),
            ref_oracle.winding_map(segs, grid, contract=contract))

    def test_fill_and_gray_equal_reference(self, fonts):
        segs = segments.pack_glyph(fonts["dejavu"][0].get_glyph("8")[0]).segments
        grid = RasterGrid.fixed_tile((0, 0, 1200, 1500), 32, 2048, 32)
        np.testing.assert_array_equal(oracle.render_fill(segs, grid),
                                      ref_oracle.render_fill(segs, grid))
        np.testing.assert_array_equal(oracle.render_gray(segs, grid),
                                      ref_oracle.render_gray(segs, grid))


def view_stream(module, upem, w, h):
    """BASELINE config 5's 30 zoom/pan events (benchmarks/configs.py:287-295)
    and the stress page's zoom (benchmarks/stress.py:109-124), as views."""
    v = module.ViewTransform.init(upem, w, h)
    views = [v]
    for i in range(30):
        if i % 3 == 0:
            v = v.zoomed(0.5 if i % 2 else -0.5, (0.1, 0.1))
        else:
            v = v.dragged(0.01, 0.005)
        views.append(v)
    v = module.ViewTransform.init(upem, 3840, 2160).zoomed(-8.0, (0.0, 0.0))
    views += [v, *(v.zoomed(0.01 * (i + 1), (0.0, 0.0)) for i in range(5))]
    return views + [v.with_aspect(w, h), v.zoomed(0, (0.3, 0.3))]


class TestTransform:
    def test_view_stream_equals_reference(self):
        local_port = transform.Transform((1.5, 0.75), (-120.0, 33.25))
        local_ref = ref_transform.Transform((1.5, 0.75), (-120.0, 33.25))
        for port, ref in zip(view_stream(transform, 2048, 1920, 1080),
                             view_stream(ref_transform, 2048, 1920, 1080), strict=True):
            assert (port.scale, port.offset, port.aspect_ratio) == (
                ref.scale, ref.offset, ref.aspect_ratio)
            for x, y in ((0.0, 0.0), (1234.5, -2380.25), (-7.0, 1e4)):
                assert port.apply(x, y) == ref.apply(x, y)
                assert port.invert(x, y) == ref.invert(x, y)
            combined, want = port.combine(local_port), ref.combine(local_ref)
            assert (combined.scale, combined.offset) == (want.scale, want.offset)

    def test_defaults_equal_reference(self):
        assert transform.ZOOM_FACTOR == ref_transform.ZOOM_FACTOR
        port, ref = transform.Transform(), ref_transform.Transform()
        assert (port.scale, port.offset) == (ref.scale, ref.offset)


# texts whose layouts the page path draws: BASELINE config 5's page
# (benchmarks/configs.py:282-285), the stress page (benchmarks/stress.py:
# 103-105), the dirty-strip tests' texts (tests/test_dirty_strip.py) and a
# glyph DejaVu Sans lacks (U+02EA draws .notdef)
LAYOUT_TEXTS = {
    "config5": "\n".join(
        "The quick brown fox jumps over the lazy dog 0123456789" for _ in range(20)),
    "stress": "\n".join(
        "The quick brown fox jumps over the lazy dog. 0123456789 " for _ in range(10000 // 56)),
    "dirty_strip": "\n".join(
        f"Paragraph {i}: quick brown foxes office {i}!" for i in range(14)),
    "short": "one\ntwo\nthree",
    "accents": "Paragraph 0: quick brown foxes office 0! QjÂÇ",
    "missing": "Ab\u02eacd\n\n  x",
    "empty": "",
}


class TestLayout:
    @pytest.mark.parametrize("name", sorted(LAYOUT_TEXTS))
    def test_equals_reference(self, fonts, name):
        port_font, ref_font = fonts["dejavu"]
        text = LAYOUT_TEXTS[name]
        port, ref = layout.layout_text(port_font, text), ref_layout.layout_text(ref_font, text)
        for got, want in zip(port.instance_arrays(), ref.instance_arrays(), strict=True):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        for field in ("segments", "seg_counts", "boxes", "advance_widths"):
            np.testing.assert_array_equal(getattr(port.batch, field),
                                          getattr(ref.batch, field))
        assert port.slot_gids == ref.slot_gids and port.slot_chars == ref.slot_chars
        assert (port.width, port.height) == (ref.width, ref.height)
        assert [(i.glyph_slot, i.x, i.y) for i in port.instances] == [
            (i.glyph_slot, i.x, i.y) for i in ref.instances]

    def test_default_options_equal_reference(self, fonts):
        port_font, ref_font = fonts["dejavu"]
        text = LAYOUT_TEXTS["short"]
        port = layout.layout_text(port_font, text, kern=False, align="left",
                                  line_height=None)
        ref = ref_layout.layout_text(ref_font, text)
        np.testing.assert_array_equal(port.batch.segments, ref.batch.segments)
        for got, want in zip(port.instance_arrays(), ref.instance_arrays(), strict=True):
            np.testing.assert_array_equal(got, want)
        assert port.height == ref.height
        assert port.instances[1].local_transform() == transform.Transform(
            offset=(port.instances[1].x, port.instances[1].y))

    @pytest.mark.parametrize("option,value", [
        ("pad_batch_to", 16), ("line_height", 1000.0), ("kern", True), ("ligatures", True), ("marks", True), ("features", (b"liga",)),
        ("vertical", True), ("positioning", (b"kern",)), ("wrap_width", 5000.0),
        ("oblique", 0.2), ("rtl", True), ("bidi", True), ("alternate", 1),
        ("letter_spacing", 10.0), ("word_spacing", 10.0), ("underline", True),
        ("strikethrough", True), ("tracking_ptem", 12.0), ("aat_features", ((1, 0),)),
        ("align", "center"), ("kashida", True),
    ])
    def test_unported_option_raises(self, fonts, option, value):
        assert option in layout.UNPORTED
        with pytest.raises(NotImplementedError, match=option):
            layout.layout_text(fonts["dejavu"][0], "ab", **{option: value})

    def test_unknown_option_raises(self, fonts):
        with pytest.raises(TypeError, match="colour"):
            layout.layout_text(fonts["dejavu"][0], "ab", colour=True)

    @pytest.mark.parametrize("text,match", [
        ("soft\u00adhyphen", "U\\+00AD \\(soft hyphen\\)"),
        ("q\u0301", "combining mark U\\+0301"),    # no precomposed q: NFC keeps the mark
        ("a\ufe0f", "U\\+FE0F"),                 # a variation selector (a mark)
        ("a\u200db", "U\\+200D: only"),          # an unmapped default-ignorable (ZWJ)
        ("\u0627\u0644", "U\\+0627: only"),     # Arabic
        ("\u05d0", "U\\+05D0: only"),           # Hebrew
        ("\u0915", "U\\+0915: only"),           # Devanagari, shaped by default
    ])
    def test_character_off_the_plain_path_raises(self, fonts, text, match):
        with pytest.raises(NotImplementedError, match=match):
            layout.layout_text(fonts["dejavu"][0], text)

    def test_nfd_fallback_raises(self):
        """A precomposed letter the font lacks, whose parts it maps, would be
        drawn as base + mark by the original."""
        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4(
            [(0x65, 0x65, -0x64, None), (0x301, 0x301, -0x2FF, None)]))])
        blob = tb.build_font([b"", square(), square(50)], cmap)
        port_font = Font(blob)
        assert port_font.glyph_index(0xE9) == 0 and port_font.glyph_index(0x65) == 1
        assert layout.layout_text(port_font, "e").instances
        with pytest.raises(NotImplementedError, match="decomposition"):
            layout.layout_text(port_font, "\u00e9")

    def test_morx_font_raises(self):
        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4([(65, 65, -64, None)]))])
        blob = tb.build_font([b"", square()], cmap,
                             extra_tables={b"morx": b"\0" * 8})
        with pytest.raises(NotImplementedError, match="morx"):
            layout.layout_text(Font(blob), "A")
