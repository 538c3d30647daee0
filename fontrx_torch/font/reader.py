"""Big-endian binary reading over an in-memory font blob, and the F2Dot14
fixed-point numbers of component transforms.

A copy of ``fontrx/utils/reader.py`` and of ``FixedPoint``/``F2D14`` from
``fontrx/utils/fixed_point.py``, cut to what the port's ``glyf`` front end
reads. ``tests/test_torch_frontend.py`` holds the front end equal to the
original.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


class CorruptedFont(ValueError):
    """A structural failure in a font file."""


class BigEndianReader:
    """Cursor-based big-endian reader over ``bytes``."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def skip(self, n: int) -> None:
        self.pos += n

    def u16(self) -> int:
        return self.unpack("H")[0]

    def u32(self) -> int:
        return self.unpack("I")[0]

    def tag(self) -> bytes:
        v = self.data[self.pos : self.pos + 4]
        self.pos += 4
        return v

    def bytes(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str) -> tuple:
        """Unpack a big-endian struct format (without the leading '>')."""
        try:
            v = struct.unpack_from(">" + fmt, self.data, self.pos)
        except struct.error:
            raise CorruptedFont("read past end of table data") from None
        self.pos += struct.calcsize(">" + fmt)
        return v

    def u16_array(self, count: int) -> np.ndarray:
        """Bulk big-endian u16 decode."""
        arr = np.frombuffer(self.data, dtype=">u2", count=count, offset=self.pos)
        self.pos += 2 * count
        return arr.astype(np.uint16)

    def u32_array(self, count: int) -> np.ndarray:
        arr = np.frombuffer(self.data, dtype=">u4", count=count, offset=self.pos)
        self.pos += 4 * count
        return arr.astype(np.uint32)


def ensure_mono_increase(arr: np.ndarray, what: str = "array") -> None:
    """Raise ``CorruptedFont`` unless ``arr`` is non-decreasing."""
    a = np.asarray(arr)
    if a.size > 1 and np.any(a[1:] < a[:-1]):
        raise CorruptedFont(f"{what} is not monotonically increasing")


@dataclass(frozen=True, slots=True)
class FixedPoint:
    """An integer-backed fixed-point value: ``value = data / 2**bias_bits``."""

    data: int
    bias_bits: int

    @classmethod
    def from_int(cls, value: int, bias_bits: int) -> "FixedPoint":
        return cls(value << bias_bits, bias_bits)


def F2D14(raw: int) -> FixedPoint:
    """TrueType F2Dot14 (signed 2.14) from its raw 16-bit pattern."""
    if raw >= 0x8000:
        raw -= 0x10000
    return FixedPoint(raw, 14)
