"""QOI (Quite OK Image) encoders and decoder.

A copy of the pure-Python RGB and RGBA encoders and the decoder of
``fontrx/io/qoi.py``: standard QOI with RUN / INDEX / DIFF / LUMA / RGB / RGBA ops,
the 64-entry running hash ``(3r+5g+7b+11a) & 63`` and the 8-byte end
marker. Run lengths and per-pixel deltas are precomputed with NumPy; only
the index-table walk is a Python loop. ``tests/test_torch_frontend.py``
holds their bytes equal to the original's.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"qoif"
END_MARKER = struct.pack(">Q", 1)

OP_INDEX = 0x00
OP_DIFF = 0x40
OP_LUMA = 0x80
OP_RUN = 0xC0
OP_RGB = 0xFE
OP_RGBA = 0xFF


def encode_rgb(pixels: np.ndarray) -> bytes:
    """Encode ``uint8 [H, W, 3]`` to QOI bytes (channels=3, sRGB)."""
    h, w = pixels.shape[:2]
    header = MAGIC + struct.pack(">IIBB", w, h, 3, 0)

    flat = pixels.reshape(-1, 3).astype(np.uint8)
    total = flat.shape[0]
    out = bytearray(header)
    if total == 0:
        out += END_MARKER
        return bytes(out)

    # wrapped deltas against the previous pixel, hashes, run breaks
    prev = np.vstack([np.zeros((1, 3), np.uint8), flat[:-1]])
    delta = (flat.astype(np.int16) - prev.astype(np.int16)) & 0xFF
    same = (delta == 0).all(axis=1)
    dr = ((delta[:, 0] + 2) & 0xFF).astype(np.uint8)
    dg = ((delta[:, 1] + 2) & 0xFF).astype(np.uint8)
    db = ((delta[:, 2] + 2) & 0xFF).astype(np.uint8)
    small = (dr < 4) & (dg < 4) & (db < 4)
    lr = (dr + (8 - dg)) & 0xFF
    lb = (db + (8 - dg)) & 0xFF
    lg = (dg + 30) & 0xFF
    luma = (lr < 16) & (lg < 64) & (lb < 16)
    hashes = (
        flat[:, 0].astype(np.uint32) * 3
        + flat[:, 1].astype(np.uint32) * 5
        + flat[:, 2].astype(np.uint32) * 7
        + 255 * 11
    ) & 63

    # a zero-initialized table: a black pixel matches any entry until it is
    # overwritten
    index = np.zeros((64, 3), np.uint8)
    i = 0
    while i < total:
        if same[i]:
            run = 1
            j = i + 1
            while j < total and same[j] and run < 62:
                run += 1
                j += 1
            out.append(OP_RUN | (run - 1))
            index[hashes[i]] = flat[i]
            i = j
            continue
        r, g, b = flat[i]
        hsh = hashes[i]
        if index[hsh, 0] == r and index[hsh, 1] == g and index[hsh, 2] == b:
            out.append(OP_INDEX | int(hsh))
        elif small[i]:
            out.append(OP_DIFF | (int(dr[i]) << 4) | (int(dg[i]) << 2) | int(db[i]))
        elif luma[i]:
            out.append(OP_LUMA | int(lg[i]))
            out.append((int(lr[i]) << 4) | int(lb[i]))
        else:
            out += bytes((OP_RGB, r, g, b))
        index[hsh] = flat[i]
        i += 1

    out += END_MARKER
    return bytes(out)


def encode_rgba(pixels: np.ndarray) -> bytes:
    """Encode ``uint8 [H, W, 4]`` to QOI bytes (channels=4).

    The session's transparent-background frames (the ``t`` key) are RGBA.
    Standard QOI semantics: DIFF/LUMA/RGB ops only when alpha is unchanged,
    OP_RGBA otherwise; the running hash includes the real alpha."""
    h, w = pixels.shape[:2]
    header = MAGIC + struct.pack(">IIBB", w, h, 4, 0)
    flat = pixels.reshape(-1, 4).astype(np.uint8)
    total = flat.shape[0]
    out = bytearray(header)
    if total == 0:
        out += END_MARKER
        return bytes(out)

    first_prev = np.array([[0, 0, 0, 255]], np.uint8)  # spec start pixel
    prev = np.vstack([first_prev, flat[:-1]])
    delta = (flat.astype(np.int16) - prev.astype(np.int16)) & 0xFF
    same = (delta == 0).all(axis=1)
    alpha_same = delta[:, 3] == 0
    dr = ((delta[:, 0] + 2) & 0xFF).astype(np.uint8)
    dg = ((delta[:, 1] + 2) & 0xFF).astype(np.uint8)
    db = ((delta[:, 2] + 2) & 0xFF).astype(np.uint8)
    small = (dr < 4) & (dg < 4) & (db < 4) & alpha_same
    lr = (dr + (8 - dg)) & 0xFF
    lb = (db + (8 - dg)) & 0xFF
    lg = (dg + 30) & 0xFF
    luma = (lr < 16) & (lg < 64) & (lb < 16) & alpha_same
    hashes = (
        flat[:, 0].astype(np.uint32) * 3
        + flat[:, 1].astype(np.uint32) * 5
        + flat[:, 2].astype(np.uint32) * 7
        + flat[:, 3].astype(np.uint32) * 11
    ) & 63

    index = np.zeros((64, 4), np.uint8)
    i = 0
    while i < total:
        if same[i]:
            run = 1
            j = i + 1
            while j < total and same[j] and run < 62:
                run += 1
                j += 1
            out.append(OP_RUN | (run - 1))
            index[hashes[i]] = flat[i]
            i = j
            continue
        r, g, b, a = flat[i]
        hsh = hashes[i]
        if (index[hsh] == flat[i]).all():
            out.append(OP_INDEX | int(hsh))
        elif small[i]:
            out.append(OP_DIFF | (int(dr[i]) << 4) | (int(dg[i]) << 2) | int(db[i]))
        elif luma[i]:
            out.append(OP_LUMA | int(lg[i]))
            out.append((int(lr[i]) << 4) | int(lb[i]))
        elif alpha_same[i]:
            out += bytes((OP_RGB, r, g, b))
        else:
            out += bytes((OP_RGBA, r, g, b, a))
        index[hsh] = flat[i]
        i += 1

    out += END_MARKER
    return bytes(out)


def decode(data: bytes, *, strict: bool = False) -> np.ndarray:
    """Decode QOI bytes to ``uint8 [H, W, channels]``: 3 channels, alpha
    dropped, for RGB files; 4 for RGBA files.

    In an RGB file alpha stays 255, also after an index op. ``encode_rgb``
    (as the original) matches a black pixel against the zero-filled index
    table, whose alpha is 0: a decoder that took that alpha would hash the
    next pixels apart from the encoder and read later index ops wrong
    (``ROADMAP.md`` queue 3). ``strict=True`` takes it, as the QOI
    specification and a standard viewer do, to show what such a viewer
    reads from a file."""
    if data[:4] != MAGIC:
        raise ValueError("not a QOI file")
    w, h, channels, _colorspace = struct.unpack(">IIBB", data[4:14])
    total = w * h
    out = np.zeros((total, 4), np.uint8)
    index = np.zeros((64, 4), np.uint8)
    r, g, b, a = 0, 0, 0, 255
    pos = 14
    i = 0
    while i < total:
        op = data[pos]
        pos += 1
        if op == OP_RGB:
            r, g, b = data[pos], data[pos + 1], data[pos + 2]
            pos += 3
        elif op == OP_RGBA:
            r, g, b, a = data[pos], data[pos + 1], data[pos + 2], data[pos + 3]
            pos += 4
        else:
            tag = op & 0xC0
            if tag == OP_INDEX:
                r, g, b, a = (int(v) for v in index[op & 63])
                if channels == 3 and not strict:
                    a = 255
            elif tag == OP_DIFF:
                r = (r + ((op >> 4) & 3) - 2) & 0xFF
                g = (g + ((op >> 2) & 3) - 2) & 0xFF
                b = (b + (op & 3) - 2) & 0xFF
            elif tag == OP_LUMA:
                dg = (op & 0x3F) - 32
                b2 = data[pos]
                pos += 1
                r = (r + dg + ((b2 >> 4) & 0xF) - 8) & 0xFF
                g = (g + dg) & 0xFF
                b = (b + dg + (b2 & 0xF) - 8) & 0xFF
            else:  # OP_RUN
                run = (op & 0x3F) + 1
                out[i : i + run] = (r, g, b, a)
                i += run
                index[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = (r, g, b, a)
                continue
        out[i] = (r, g, b, a)
        i += 1
        index[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = (r, g, b, a)
    if data[pos : pos + 8] != END_MARKER:
        raise ValueError("bad QOI end marker")
    out = out.reshape(h, w, 4)
    return out if channels == 4 else out[:, :, :3]
