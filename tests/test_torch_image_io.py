"""The port's image files (ibgs_tpu_torch/utils/image_io.py) against cv2
and PIL, and its depth colours against ibgs_tpu's.

* PNGs the port writes decode in cv2 and PIL to the same uint8 (gray, RGB,
  RGBA), and its bytes repeat exactly;
* PNGs cv2 and PIL write (gray, gray + alpha, RGB, RGBA; compression 0 and
  9; smooth images, so that the adaptive row filters 1-4 all occur) decode
  in the port to the same uint8;
* `read_image` / `write_image` of JPEG through PIL, and the ImportError
  naming the extension and `--src_image_ext png` when neither PIL nor cv2
  imports;
* `MAGMA_RGB` equals cv2's COLORMAP_MAGMA, and the render driver's
  `_colorize_depth` equals `ibgs_tpu.eval.render_driver._colorize_depth`
  exactly (float64) on seeded depth maps, one with no positive depth.
"""
import builtins
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from ibgs_tpu.eval import render_driver as jrd
from ibgs_tpu_torch.eval import render_driver as trd
from ibgs_tpu_torch.utils import image_io
from tests.test_torch_slice import one_torch_thread  # noqa: F401

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _smooth(seed, h, w, c):
    """A seeded uint8 image with smooth gradients and noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2)[..., None] + 40 * np.arange(c)
    img = (base + r.integers(0, 6, (h, w, c))) % 256
    return img.astype(np.uint8)


def _cv2_layout(a):
    """RGB(A) → cv2's BGR(A)."""
    if a.ndim == 3 and a.shape[-1] == 3:
        return a[..., ::-1]
    if a.ndim == 3 and a.shape[-1] == 4:
        return a[..., [2, 1, 0, 3]]
    return a


@pytest.mark.parametrize("c", [1, 3, 4])
def test_port_png_decodes_in_cv2_and_pil(c, tmp_path):
    img = _smooth(c, 37, 53, c)
    img = img[..., 0] if c == 1 else img
    p = str(tmp_path / "a.png")
    image_io.write_png(p, img)
    assert np.array_equal(np.asarray(Image.open(p)), img)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert np.array_equal(back, _cv2_layout(img))
    q = str(tmp_path / "b.png")
    image_io.write_png(q, img)
    assert open(p, "rb").read() == open(q, "rb").read()


@pytest.mark.parametrize("level", [0, 9])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_cv2_and_pil_pngs_decode_in_the_port(c, level, tmp_path):
    img = _smooth(10 * c + level, 41, 67, c)
    img = img[..., 0] if c == 1 else img
    p = str(tmp_path / "pil.png")
    Image.fromarray(img, MODES[c]).save(p, compress_level=level)
    assert np.array_equal(image_io.read_png(p), img)
    if c != 2:                          # cv2 writes no gray + alpha
        q = str(tmp_path / "cv2.png")
        assert cv2.imwrite(q, _cv2_layout(img),
                           [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert np.array_equal(image_io.read_png(q), img)
    assert image_io.png_size(p) == (67, 41)


def test_every_row_filter_decodes(tmp_path):
    """A PNG whose rows cycle through filter types 0-4 (built here with
    each filter's definition) decodes to the image."""
    img = _smooth(5, 20, 31, 3)
    h, w, c = img.shape
    prev = np.zeros(w * c, np.int64)
    rows = []
    for y in range(h):
        x = img[y].reshape(-1).astype(np.int64)
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        cc = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        p = a + prev - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, cc))
        ft = y % 5
        pred = [0, a, prev, (a + prev) // 2, paeth][ft]
        rows.append(np.concatenate([[ft], (x - pred) % 256]).astype(np.uint8))
        prev = x
    import struct
    chunk = image_io._chunk
    data = (image_io._SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes()))
            + chunk(b"IEND", b""))
    p = tmp_path / "f.png"
    p.write_bytes(data)
    assert np.array_equal(image_io.read_png(str(p)), img)
    assert np.array_equal(np.asarray(Image.open(str(p))), img)


def test_jpeg_through_pil(tmp_path):
    img = _smooth(7, 32, 48, 3)
    p = str(tmp_path / "a.jpg")
    image_io.write_image(p, img)
    got = image_io.read_image(p)
    assert got.shape == img.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - img).mean() < 4      # quality 95
    with pytest.raises(ValueError, match="tiff"):
        image_io.write_image(str(tmp_path / "a.tiff"), img)


def test_jpeg_without_a_codec_raises(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_codec(name, *a, **k):
        if name in ("PIL", "cv2") or name.startswith("PIL."):
            raise ImportError(f"no module named {name}")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_codec)
    img = _smooth(8, 8, 8, 3)
    for call in (lambda: image_io.write_image(str(tmp_path / "x.jpg"), img),
                 lambda: image_io.read_image(str(tmp_path / "x.jpeg"))):
        with pytest.raises(ImportError, match=r"\.jpe?g.*--src_image_ext png"):
            call()
    image_io.write_image(str(tmp_path / "x.png"), img)     # PNG needs none
    assert np.array_equal(image_io.read_image(str(tmp_path / "x.png")), img)


def test_magma_table_and_depth_colours_match():
    want = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                             cv2.COLORMAP_MAGMA)[:, 0, ::-1]
    assert np.array_equal(image_io.MAGMA_RGB, want)
    r = np.random.default_rng(4)
    depths = [r.uniform(0.5, 6.0, (24, 40)).astype(np.float32),
              np.where(r.random((24, 40)) < 0.3, 0.0,
                       r.uniform(1, 3, (24, 40))).astype(np.float32),
              np.zeros((24, 40), np.float32),
              -r.uniform(0, 1, (24, 40)).astype(np.float32)]
    for d in depths:
        a, b = trd._colorize_depth(d), jrd._colorize_depth(d)
        assert a.dtype == b.dtype == np.float64
        assert np.array_equal(a, b)
