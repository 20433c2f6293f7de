"""The port's PNG codec (svo_raytracer_torch/io/image.py: zlib and struct,
no imaging package) against the JAX package's io/image.py, which uses
PIL: the port reads what PIL and the JAX writer write, PIL reads what the
port writes, and the pixels are equal (exact) for 8-bit gray, gray +
alpha, RGB, RGBA and palette images and 16-bit gray, with every row
filter; ``write_png`` quantizes and flips as the JAX writer does, and
``read_heightmap`` equals JAX's.  Files are compared by pixels, not
bytes: the two compress differently."""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from svo_raytracer_tpu.io import image as jimage
from svo_raytracer_torch.io import image

SHAPES = {
    "gray8": ((23, 31), np.uint8),
    "gray_alpha8": ((23, 31, 2), np.uint8),
    "rgb8": ((23, 31, 3), np.uint8),
    "rgba8": ((23, 31, 4), np.uint8),
    "gray16": ((23, 31), np.uint16),
}


def _pixels(shape, dt, seed=0):
    """Smooth ramps with a noisy patch: PIL's adaptive filter then picks
    Sub, Up and Paeth rows."""
    gen = np.random.default_rng(seed)
    top = np.iinfo(dt).max
    y, x = np.mgrid[:shape[0], :shape[1]]
    base = (x * 7 + y * 13) % (top + 1)
    a = np.broadcast_to(base[..., None] if len(shape) == 3 else base,
                        shape).copy()
    if len(shape) == 3:
        a = (a + np.arange(shape[2]) * 40) % (top + 1)
    a[5:12, 4:20] = gen.integers(0, top + 1, a[5:12, 4:20].shape)
    return a.astype(dt)


@pytest.mark.parametrize("name", list(SHAPES))
def test_read_and_write_equal_pil(name, tmp_path):
    shape, dt = SHAPES[name]
    a = _pixels(shape, dt)
    path = str(tmp_path / "pil.png")
    Image.fromarray(a).save(path)
    np.testing.assert_array_equal(image.read_png(path), jimage.read_png(path))
    np.testing.assert_array_equal(image.read_png(path), a)
    mine = str(tmp_path / "port.png")
    image.write_png_array(mine, a)
    got = jimage.read_png(mine)
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("colours", [2, 4, 16, 200])
def test_palette_reads_as_indices(colours, tmp_path):
    """PIL writes 1, 2, 4 and 8-bit palettes by the colours used."""
    idx = (_pixels((17, 9), np.uint8) % colours).astype(np.uint8)
    img = Image.fromarray(idx).convert("P")
    img.putpalette([i % 256 for i in range(3 * colours)])
    path = str(tmp_path / "pal.png")
    img.save(path)
    got = image.read_png(path)
    np.testing.assert_array_equal(got, jimage.read_png(path))
    np.testing.assert_array_equal(got, idx)


def _filtered_png(a, kinds):
    """PNG bytes of the (H, W, 3) uint8 ``a`` with row y filtered by
    kinds[y % len(kinds)] (PNG spec section 9)."""
    h, w, c = a.shape
    raw = a.reshape(h, -1).astype(np.int64)
    out, prev = bytearray(), np.zeros(w * c, np.int64)
    for y in range(h):
        k, cur = kinds[y % len(kinds)], raw[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if k == 0:
            f = cur
        elif k == 1:
            f = cur - left
        elif k == 2:
            f = cur - prev
        elif k == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left,
                               np.where(pb <= pc, prev, upleft))
        out += bytes([k]) + bytes((f % 256).astype(np.uint8))
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


def test_every_row_filter():
    a = _pixels((20, 13, 3), np.uint8, seed=4)
    data = _filtered_png(a, (0, 1, 2, 3, 4))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  a)
    np.testing.assert_array_equal(image.decode_png(data), a)


def test_write_png_quantizes_like_jax(tmp_path):
    gen = np.random.default_rng(2)
    color = gen.uniform(-0.2, 1.2, (18, 26, 3)).astype(np.float32)
    color[3, 4] = np.nan
    color[5, 6, 1] = np.inf
    for flip in (True, False):
        jax_path, port_path = (str(tmp_path / f"{n}{flip}.png")
                               for n in ("jax", "port"))
        jimage.write_png(jax_path, color, flip=flip)
        image.write_png(port_path, torch.from_numpy(color), flip=flip)
        want = jimage.read_png(jax_path)
        np.testing.assert_array_equal(jimage.read_png(port_path), want)
        np.testing.assert_array_equal(image.read_png(jax_path), want)
        np.testing.assert_array_equal(image.quantize(color, flip), want)


@pytest.mark.parametrize("name", ["gray8", "rgb8", "gray16"])
def test_read_heightmap_equals_jax(name, tmp_path):
    shape, dt = SHAPES[name]
    path = str(tmp_path / "hm.png")
    Image.fromarray(_pixels(shape, dt, seed=9)).save(path)
    got, want = image.read_heightmap(path), jimage.read_heightmap(path)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_unsupported_and_broken_files_raise():
    good = image.encode_png(_pixels((4, 5, 3), np.uint8))
    for bad in (b"GIF89a" + good[6:], good[:40]):
        with pytest.raises(ValueError):
            image.decode_png(bad)
    with pytest.raises(ValueError):
        image.encode_png(np.zeros((4, 5, 3), np.uint16))
