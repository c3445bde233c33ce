"""Image files without OpenCV or PIL.

The card's machine has neither `cv2` nor `PIL`, so the port reads and
writes PNG itself:

* `write_png`: 8-bit gray, RGB or RGBA, filter type 0 on every row, one
  zlib stream (level 6), so the same pixels always give the same bytes;
* `read_png`: 8-bit gray, gray + alpha, RGB and RGBA, non-interlaced,
  with all five row filters (files from cv2, PIL and image editors use
  the adaptive ones), returned in `np.asarray(PIL.Image.open(path))`'s
  layout: (H, W) for gray, (H, W, C) otherwise;
* `read_image` / `write_image`: `.png` through the codec above; `.jpg` /
  `.jpeg` through PIL, else cv2, and an ImportError naming the extension
  and `--src_image_ext png` when neither imports (a refusal, not a
  fallback); any other extension raises ValueError;
* `MAGMA_RGB`: OpenCV's COLORMAP_MAGMA as a (256, 3) uint8 RGB table,
  the depth colours of the render driver.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit depth only)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}

# cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
#                   cv2.COLORMAP_MAGMA)[:, 0, ::-1]
MAGMA_RGB = np.array([
    0, 0, 4, 1, 0, 5, 1, 1, 6, 1, 1, 8,
    2, 1, 9, 2, 2, 11, 2, 2, 13, 3, 3, 15,
    3, 3, 18, 4, 4, 20, 5, 4, 22, 6, 5, 24,
    6, 5, 26, 7, 6, 28, 8, 7, 30, 9, 7, 32,
    10, 8, 34, 11, 9, 36, 12, 9, 38, 13, 10, 41,
    14, 11, 43, 16, 11, 45, 17, 12, 47, 18, 13, 49,
    19, 13, 52, 20, 14, 54, 21, 14, 56, 22, 15, 59,
    24, 15, 61, 25, 16, 63, 26, 16, 66, 28, 16, 68,
    29, 17, 71, 30, 17, 73, 32, 17, 75, 33, 17, 78,
    34, 17, 80, 36, 18, 83, 37, 18, 85, 39, 18, 88,
    41, 17, 90, 42, 17, 92, 44, 17, 95, 45, 17, 97,
    47, 17, 99, 49, 17, 101, 51, 16, 103, 52, 16, 105,
    54, 16, 107, 56, 16, 108, 57, 15, 110, 59, 15, 112,
    61, 15, 113, 63, 15, 114, 64, 15, 116, 66, 15, 117,
    68, 15, 118, 69, 16, 119, 71, 16, 120, 73, 16, 120,
    74, 16, 121, 76, 17, 122, 78, 17, 123, 79, 18, 123,
    81, 18, 124, 82, 19, 124, 84, 19, 125, 86, 20, 125,
    87, 21, 126, 89, 21, 126, 90, 22, 126, 92, 22, 127,
    93, 23, 127, 95, 24, 127, 96, 24, 128, 98, 25, 128,
    100, 26, 128, 101, 26, 128, 103, 27, 128, 104, 28, 129,
    106, 28, 129, 107, 29, 129, 109, 29, 129, 110, 30, 129,
    112, 31, 129, 114, 31, 129, 115, 32, 129, 117, 33, 129,
    118, 33, 129, 120, 34, 129, 121, 34, 130, 123, 35, 130,
    124, 35, 130, 126, 36, 130, 128, 37, 130, 129, 37, 129,
    131, 38, 129, 132, 38, 129, 134, 39, 129, 136, 39, 129,
    137, 40, 129, 139, 41, 129, 140, 41, 129, 142, 42, 129,
    144, 42, 129, 145, 43, 129, 147, 43, 128, 148, 44, 128,
    150, 44, 128, 152, 45, 128, 153, 45, 128, 155, 46, 127,
    156, 46, 127, 158, 47, 127, 160, 47, 127, 161, 48, 126,
    163, 48, 126, 165, 49, 126, 166, 49, 125, 168, 50, 125,
    170, 51, 125, 171, 51, 124, 173, 52, 124, 174, 52, 123,
    176, 53, 123, 178, 53, 123, 179, 54, 122, 181, 54, 122,
    183, 55, 121, 184, 55, 121, 186, 56, 120, 188, 57, 120,
    189, 57, 119, 191, 58, 119, 192, 58, 118, 194, 59, 117,
    196, 60, 117, 197, 60, 116, 199, 61, 115, 200, 62, 115,
    202, 62, 114, 204, 63, 113, 205, 64, 113, 207, 64, 112,
    208, 65, 111, 210, 66, 111, 211, 67, 110, 213, 68, 109,
    214, 69, 108, 216, 69, 108, 217, 70, 107, 219, 71, 106,
    220, 72, 105, 222, 73, 104, 223, 74, 104, 224, 76, 103,
    226, 77, 102, 227, 78, 101, 228, 79, 100, 229, 80, 100,
    231, 82, 99, 232, 83, 98, 233, 84, 98, 234, 86, 97,
    235, 87, 96, 236, 88, 96, 237, 90, 95, 238, 91, 94,
    239, 93, 94, 240, 95, 94, 241, 96, 93, 242, 98, 93,
    242, 100, 92, 243, 101, 92, 244, 103, 92, 244, 105, 92,
    245, 107, 92, 246, 108, 92, 246, 110, 92, 247, 112, 92,
    247, 114, 92, 248, 116, 92, 248, 118, 92, 249, 120, 93,
    249, 121, 93, 249, 123, 93, 250, 125, 94, 250, 127, 94,
    250, 129, 95, 251, 131, 95, 251, 133, 96, 251, 135, 97,
    252, 137, 97, 252, 138, 98, 252, 140, 99, 252, 142, 100,
    252, 144, 101, 253, 146, 102, 253, 148, 103, 253, 150, 104,
    253, 152, 105, 253, 154, 106, 253, 155, 107, 254, 157, 108,
    254, 159, 109, 254, 161, 110, 254, 163, 111, 254, 165, 113,
    254, 167, 114, 254, 169, 115, 254, 170, 116, 254, 172, 118,
    254, 174, 119, 254, 176, 120, 254, 178, 122, 254, 180, 123,
    254, 182, 124, 254, 183, 126, 254, 185, 127, 254, 187, 129,
    254, 189, 130, 254, 191, 132, 254, 193, 133, 254, 194, 135,
    254, 196, 136, 254, 198, 138, 254, 200, 140, 254, 202, 141,
    254, 204, 143, 254, 205, 144, 254, 207, 146, 254, 209, 148,
    254, 211, 149, 254, 213, 151, 254, 215, 153, 254, 216, 154,
    253, 218, 156, 253, 220, 158, 253, 222, 160, 253, 224, 161,
    253, 226, 163, 253, 227, 165, 253, 229, 167, 253, 231, 169,
    253, 233, 170, 253, 235, 172, 252, 236, 174, 252, 238, 176,
    252, 240, 178, 252, 242, 180, 252, 244, 182, 252, 246, 184,
    252, 247, 185, 252, 249, 187, 252, 251, 189, 252, 253, 191,
], dtype=np.uint8).reshape(256, 3)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write an (H, W) or (H, W, C) uint8 image, C in 1..4, as a PNG."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png: uint8 expected, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOUR_TYPE:
        raise ValueError(f"write_png: (H, W[, 1-4]) expected, got {a.shape}")
    h, w, c = a.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)      # filter byte 0 per row
    rows[:, 1:] = a.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        yield data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _header(path: str, data: bytes):
    tag, ihdr = next(_chunks(data))
    if tag != b"IHDR":
        raise ValueError(f"{path}: no IHDR chunk")
    return struct.unpack(">IIBBBBB", ihdr)


def png_size(path: str):
    """(width, height) of a PNG, from its header."""
    with open(path, "rb") as f:
        w, h, *_ = _header(path, f.read(33))
    return w, h


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-row PNG filters of 8-bit pixels.  Rows of filter 0
    copy through; otherwise the image is rebuilt along anti-diagonals
    (pixel (r, x) needs (r, x-1), (r-1, x) and (r-1, x-1), so every pixel
    with r + x = t depends only on earlier diagonals), one vectorised step
    per diagonal instead of one per pixel."""
    ftype = raw[:, 0]
    filt = raw[:, 1:].reshape(h, w, c)
    if not ftype.any():
        return filt.copy()
    if int(ftype.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    out = np.zeros((h + 1, w + 1, c), np.int16)     # zero row and column
    f16 = filt.astype(np.int16)
    ft = ftype.astype(np.int16)[:, None]
    for t in range(h + w - 1):
        r = np.arange(max(0, t - w + 1), min(t, h - 1) + 1)
        x = t - r
        a = out[r + 1, x]               # left
        b = out[r, x + 1]               # up
        cc = out[r, x]                  # up-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        k = ft[r]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (f16[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG as uint8: (H, W) gray, (H, W, 2) gray + alpha,
    (H, W, 3) RGB or (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, depth, ctype, _comp, _filt, interlace = _header(path, data)
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, RGB and "
                         f"RGBA PNGs are read (bit depth {depth}, colour "
                         f"type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    idat = b"".join(d for tag, d in _chunks(data) if tag == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data, expected "
                         f"{h * (1 + w * c)}")
    img = _unfilter(raw.reshape(h, 1 + w * c), h, w, c)
    return img[..., 0] if c == 1 else img


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def _jpeg_codec(path: str):
    """PIL's Image module, else cv2; ImportError naming the way out."""
    try:
        from PIL import Image
        return "pil", Image
    except ImportError:
        pass
    try:
        import cv2
        return "cv2", cv2
    except ImportError:
        raise ImportError(
            f"{path}: no JPEG codec for '{_ext(path)}' (neither PIL nor cv2 "
            f"imports); write PNG instead (--src_image_ext png)") from None


def write_image(path: str, img: np.ndarray):
    """Write a uint8 (H, W[, C]) RGB(A) image; the extension picks the
    format (.png, .jpg / .jpeg at quality 95, cv2's default)."""
    ext = _ext(path)
    if ext == ".png":
        return write_png(path, img)
    if ext not in (".jpg", ".jpeg"):
        raise ValueError(f"{path}: unsupported image extension '{ext}'")
    kind, mod = _jpeg_codec(path)
    a = np.asarray(img)
    if kind == "pil":
        mod.fromarray(a).save(path, quality=95)
    elif not mod.imwrite(path, a[..., ::-1] if a.ndim == 3 else a):
        raise OSError(f"cv2 could not write {path}")


def read_image(path: str) -> np.ndarray:
    """A uint8 image in `np.asarray(PIL.Image.open(path))`'s layout."""
    ext = _ext(path)
    if ext == ".png":
        return read_png(path)
    if ext not in (".jpg", ".jpeg"):
        raise ValueError(f"{path}: unsupported image extension '{ext}'")
    kind, mod = _jpeg_codec(path)
    if kind == "pil":
        with mod.open(path) as im:
            return np.asarray(im)
    a = mod.imread(path, mod.IMREAD_UNCHANGED)
    if a is None:
        raise OSError(f"cv2 could not read {path}")
    return a[..., ::-1] if a.ndim == 3 else a
