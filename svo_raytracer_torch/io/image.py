"""PNG read and write for renders, heightmaps and material maps (port of
svo_raytracer_tpu/io/image.py, which uses PIL).

The port encodes and decodes PNG itself with ``zlib`` and ``struct``, so
it needs no imaging package: non-interlaced 8-bit gray, gray + alpha,
RGB and RGBA images, 16-bit gray, and palette images of 1 to 8 bits (a
palette image reads as its index array, as PIL's does).  The writer
emits filter type 0 rows at zlib level 6; the reader undoes all five
row filters.  Sub and Up rows decode as whole-row array operations;
Average and Paeth rows depend on the byte decoded just before and decode
byte by byte in Python, so a large image filtered that way reads slowly.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> channels per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) or (H, W, C) uint8 array (C = 1..4: gray,
    gray + alpha, RGB, RGBA) or an (H, W) uint16 gray array; row 0 is the
    top row."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"cannot write an image of shape {np.shape(img)}")
    if a.dtype == np.uint16 and a.shape[2] == 1:
        depth, a = 16, a.astype(">u2")
    elif a.dtype == np.uint8:
        depth = 8
    else:
        raise ValueError(f"cannot write {a.dtype} with {a.shape[2]} "
                         f"channels: uint8, or uint16 gray")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           a.reshape(h, -1).view(np.uint8)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[a.shape[2]], 0,
                       0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter_bytes(kind, line, prev, bpp):
    """Average (3) or Paeth (4) row reconstruction, byte by byte."""
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            out[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 array, or (H, W) uint16 for 16-bit gray,
    of PNG bytes; row 0 is the top row."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:
                                                                 pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    ok = {0: (8, 16), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
    if interlace or depth not in ok.get(ctype, ()):
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    stride = -(-w * ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data of the wrong size")
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = _unfilter_bytes(kind, line.tobytes(), prev.tobytes(), bpp)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w)
    if depth < 8:   # palette indices, packed from the high bits down
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        idx = (out[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
        return idx.reshape(h, -1)[:, :w]
    return out.reshape(h, w) if ch == 1 else out.reshape(h, w, ch)


def write_png_array(path: str, img: np.ndarray) -> None:
    """Write an integer image as it is (:func:`encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_png(path: str, color, flip: bool = True) -> None:
    """Write an (H, W, 3) float image in [0,1] (a NumPy array, or a tensor
    on any device).  ``flip`` converts from GL row order (row 0 = bottom)
    to PNG row order (row 0 = top)."""
    write_png_array(path, quantize(color, flip))


def quantize(color, flip: bool = True) -> np.ndarray:
    """The uint8 pixels :func:`write_png` writes: NaN -> 1, clipped to
    [0, 1], times 255, truncated; rows flipped from GL order."""
    if hasattr(color, "detach"):
        color = color.detach().cpu().numpy()
    img = np.nan_to_num(np.asarray(color), nan=1.0, posinf=1.0, neginf=0.0)
    img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return img[::-1] if flip else img


def read_png(path: str) -> np.ndarray:
    """(H, W) or (H, W, C) uint8/uint16 array."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_heightmap(path: str) -> np.ndarray:
    """16-bit single-channel heightmap like stbi_load_16 (Octree.java:208):
    the first channel, 8-bit samples scaled by 257."""
    arr = read_png(path)
    if arr.ndim == 3:
        arr = arr[..., 0]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.uint16) * 257
    return arr.astype(np.uint16)
