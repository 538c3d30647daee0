"""COLR v0 colour layers and CPAL palettes.

A copy of the version-0 part of ``fontrx/font/colr.py``: the COLR header,
its base-glyph records and layer records (``ColrTable.parse``, ``layers``;
``clip_box`` is ``None``, as for every v0 table), and the CPAL palettes
(``CpalTable``: ``parse``, ``color`` with the 0xFFFF foreground sentinel,
``select("light" | "dark")``). ``tests/test_torch_color.py`` holds it equal
to the original.

A COLR table of version 1 or later raises ``NotImplementedError`` (ROADMAP
item 13b): the original renders such a glyph from its v1 paint graph where
it has one, so reading only the v0 records would draw another picture.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fontrx_torch.font.reader import BigEndianReader, CorruptedFont

# the CPAL palette entry that means the text's foreground colour
FOREGROUND = 0xFFFF


@dataclass(frozen=True, slots=True)
class ColrTable:
    """COLR v0 layer records: ``base_gids`` sorted, with ``first_layer`` and
    ``num_layers`` parallel to it indexing the layer records (``layer_gids``,
    ``layer_palettes``)."""

    version: int
    base_gids: np.ndarray       # uint16 [B], sorted
    first_layer: np.ndarray     # uint16 [B]
    num_layers: np.ndarray      # uint16 [B]
    layer_gids: np.ndarray      # uint16 [L]
    layer_palettes: np.ndarray  # uint16 [L] (a palette entry or 0xFFFF)

    @classmethod
    def parse(cls, r: BigEndianReader) -> "ColrTable":
        base = r.pos
        version, n_base = r.unpack("HH")
        if version >= 1:
            raise NotImplementedError(
                f"COLR version {version}: only COLR v0 layers are ported (ROADMAP item 13b)")
        base_off, layer_off = r.unpack("II")
        (n_layers,) = r.unpack("H")
        if n_base:
            rec = BigEndianReader(r.data, base + base_off).u16_array(3 * n_base)
            rec = rec.reshape(n_base, 3)
        else:
            rec = np.zeros((0, 3), np.uint16)
        if n_layers:
            lay = BigEndianReader(r.data, base + layer_off).u16_array(2 * n_layers)
            lay = lay.reshape(n_layers, 2)
        else:
            lay = np.zeros((0, 2), np.uint16)
        first = rec[:, 1].astype(np.int64)
        count = rec[:, 2].astype(np.int64)
        if len(rec) and (first + count).max(initial=0) > n_layers:
            raise CorruptedFont("COLR layer range past layer records")
        return cls(int(version), rec[:, 0].copy(), rec[:, 1].copy(), rec[:, 2].copy(),
                   lay[:, 0].copy(), lay[:, 1].copy())

    def clip_box(self, gid: int):
        """The ClipList's bounds for ``gid``: a v0 table has no ClipList."""
        return None

    def layers(self, gid: int) -> list[tuple[int, int]] | None:
        """``[(layer_gid, palette_entry), ...]`` painting bottom to top, or
        ``None`` when ``gid`` is not a base glyph."""
        i = int(np.searchsorted(self.base_gids, gid))
        if i >= len(self.base_gids) or int(self.base_gids[i]) != gid:
            return None
        lo = int(self.first_layer[i])
        n = int(self.num_layers[i])
        return [(int(self.layer_gids[j]), int(self.layer_palettes[j]))
                for j in range(lo, lo + n)]


@dataclass(frozen=True, slots=True)
class CpalTable:
    """CPAL palettes: ``colors[p, e]`` is RGBA uint8."""

    version: int
    colors: np.ndarray  # uint8 [numPalettes, numPaletteEntries, 4] RGBA
    # CPAL v1 paletteTypes per palette (0 when absent): bit 0 usable on a
    # light background, bit 1 on a dark one
    palette_types: tuple = ()

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CpalTable":
        base = r.pos
        version, n_entries, n_palettes, n_records = r.unpack("HHHH")
        (records_off,) = r.unpack("I")
        if n_entries == 0 or n_palettes == 0:
            raise CorruptedFont("CPAL with no palettes")
        starts = r.u16_array(n_palettes).astype(np.int64)
        types = (0,) * n_palettes
        if version >= 1:
            # the paletteTypes array; the labels only annotate, and are skipped
            try:
                (types_off,) = r.unpack("I")
                if types_off:
                    tr = BigEndianReader(r.data, base + types_off)
                    types = tuple(int(v) for v in tr.u32_array(n_palettes))
            except ValueError:
                types = (0,) * n_palettes
        if (starts + n_entries).max() > n_records:
            raise CorruptedFont("CPAL palette start past color records")
        bgra = np.frombuffer(BigEndianReader(r.data, base + records_off).bytes(4 * n_records),
                             np.uint8).reshape(n_records, 4)
        rgba = bgra[:, [2, 1, 0, 3]]
        colors = np.stack([rgba[s : s + n_entries] for s in starts])
        return cls(int(version), colors.copy(), types)

    @property
    def num_palettes(self) -> int:
        return self.colors.shape[0]

    @property
    def num_entries(self) -> int:
        return self.colors.shape[1]

    def color(self, palette: int, entry: int,
              foreground: tuple[int, int, int, int] = (0, 0, 0, 255)) -> tuple[int, int, int, int]:
        """RGBA of ``entry`` in ``palette``; the 0xFFFF sentinel is the text's
        foreground colour."""
        if entry == FOREGROUND:
            return foreground
        if not 0 <= palette < self.num_palettes:
            raise IndexError(f"palette {palette} of {self.num_palettes}")
        if not 0 <= entry < self.num_entries:
            raise CorruptedFont(f"palette entry {entry} of {self.num_entries}")
        return tuple(int(v) for v in self.colors[palette, entry])

    def select(self, which) -> int:
        """A palette selector as an index: an int passes through; ``"light"``
        and ``"dark"`` pick the first palette whose CPAL v1 paletteTypes flag
        it usable on that background, else palette 0."""
        if isinstance(which, int):
            return which
        bit = {"light": 1, "dark": 2}.get(str(which).lower())
        if bit is None:
            raise ValueError(f"palette selector {which!r}")
        for i, t in enumerate(self.palette_types):
            if t & bit:
                return i
        return 0
