"""The port's image reader (``deeplearning4j_tpu_torch/datasets/
imagefile.py``) against PIL, which this machine has and the card's
lacks: decode, ``convert`` and ``resize`` bit for bit, on seeded images
PIL writes (JPEG at three chroma samplings, two qualities, restart
markers and optimized tables; PNG in every colour type it writes,
palette and 1-bit too; PPM, PGM and BMP), and the LFW reader on a JPEG
tree against the JAX package's, which reads it through PIL.
"""

import io

import numpy as np
import pytest
from PIL import Image

from deeplearning4j_tpu.datasets import lfw as j_lfw
from deeplearning4j_tpu_torch.datasets import imagefile
from deeplearning4j_tpu_torch.datasets import lfw as t_lfw


def _smooth(h, w, c, seed=0):
    """A photo-like image: smooth waves plus noise, so JPEG keeps many
    coefficients and every code length turns up."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([np.sin(x / 7.0 + k) * 60 + np.cos(y / 5.0 - k) * 60 + 128
                  + rng.randn(h, w) * 20 for k in range(c)], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def _saved(arr, mode, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _pil(data):
    return Image.open(io.BytesIO(data))


@pytest.mark.parametrize("h,w", [(250, 250), (17, 13), (5, 3)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [90, 30])
def test_jpeg_decode_is_pils(h, w, subsampling, quality):
    data = _saved(_smooth(h, w, 3), "RGB", "JPEG", quality=quality,
                  subsampling=subsampling)
    mode, got, _ = imagefile.decode_jpeg(data)
    assert mode == "RGB"
    np.testing.assert_array_equal(got, np.asarray(_pil(data)))


@pytest.mark.parametrize("kw", [dict(restart_marker_blocks=7),
                                dict(restart_marker_rows=1, subsampling=2),
                                dict(optimize=True)], ids=str)
def test_jpeg_restart_markers_and_optimized_tables_are_pils(kw):
    data = _saved(_smooth(40, 57, 3, seed=1), "RGB", "JPEG", quality=85,
                  **kw)
    np.testing.assert_array_equal(imagefile.decode_jpeg(data)[1],
                                  np.asarray(_pil(data)))


def test_grayscale_jpeg_is_pils():
    data = _saved(_smooth(33, 70, 1)[..., 0], "L", "JPEG", quality=75)
    mode, got, _ = imagefile.decode_jpeg(data)
    assert mode == "L"
    np.testing.assert_array_equal(got, np.asarray(_pil(data)))


def test_progressive_jpeg_is_refused():
    data = _saved(_smooth(16, 16, 3), "RGB", "JPEG", progressive=True)
    with pytest.raises(ValueError, match="SOF2"):
        imagefile.decode_jpeg(data)


@pytest.mark.parametrize("mode,shape", [("L", (13, 17)), ("RGB", (20, 16, 3)),
                                        ("RGBA", (9, 31, 4)),
                                        ("LA", (7, 5, 2))])
@pytest.mark.parametrize("optimize", [False, True])
def test_png_decode_and_convert_are_pils(mode, shape, optimize):
    a = np.random.RandomState(2).randint(0, 256, shape, dtype=np.uint8)
    data = _saved(a, mode, "PNG", optimize=optimize)
    img = imagefile.decode_png(data)
    for to in ("RGB", "L"):
        np.testing.assert_array_equal(imagefile.convert(img, to),
                                      np.asarray(_pil(data).convert(to)))


def test_png_filters_palette_and_one_bit_are_pils():
    smooth = _smooth(40, 37, 3)
    assert np.array_equal(imagefile.decode_png(
        _saved(smooth, "RGB", "PNG"))[1], smooth)
    pal = Image.fromarray(_smooth(30, 20, 3)).convert(
        "P", palette=Image.ADAPTIVE, colors=16)
    one = Image.fromarray((np.random.RandomState(3).rand(11, 13) > 0.5)
                          .astype(np.uint8) * 255).convert("1")
    for im, kw in ((pal, {}), (pal, {"bits": 4}), (one, {})):
        buf = io.BytesIO()
        im.save(buf, "PNG", **kw)
        img = imagefile.decode_png(buf.getvalue())
        for to in ("RGB", "L"):
            np.testing.assert_array_equal(
                imagefile.convert(img, to),
                np.asarray(_pil(buf.getvalue()).convert(to)))


@pytest.mark.parametrize("fmt,mode", [("PPM", "RGB"), ("PPM", "L"),
                                      ("BMP", "RGB")])
def test_pnm_and_bmp_are_pils(fmt, mode, tmp_path):
    a = _smooth(12, 7, 3)
    path = tmp_path / f"x.{fmt.lower()}"
    Image.fromarray(a if mode == "RGB" else a[..., 0], mode).save(path, fmt)
    np.testing.assert_array_equal(imagefile.convert(
        imagefile.read(str(path)), "RGB"),
        np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("h,w,c", [(20, 16, 3), (250, 250, 3), (7, 9, 1)])
@pytest.mark.parametrize("size", [(10, 12), (100, 100), (16, 20), (3, 5),
                                  (37, 40)])
def test_resize_is_pils_bicubic(h, w, c, size):
    a = _smooth(h, w, c)
    a = a if c == 3 else a[..., 0]
    ref = np.asarray(Image.fromarray(a, "RGB" if c == 3 else "L")
                     .resize(size))
    np.testing.assert_array_equal(imagefile.resize(a, *size), ref)


@pytest.mark.parametrize("kw", [dict(img_dim=(62, 47, 3)),
                                dict(img_dim=(32, 32, 1), flat=True)])
def test_lfw_jpeg_tree_gives_the_jax_arrays(tmp_path, kw):
    root = tmp_path / "lfw"
    for p, person in enumerate(("Ada_Lovelace", "Alan_Turing")):
        d = root / person
        d.mkdir(parents=True)
        for i in range(2 + p):
            Image.fromarray(_smooth(250, 250, 3, seed=10 * p + i)).save(
                d / f"{person}_{i + 1:04d}.jpg", quality=80)
    j = j_lfw.LFWDataSetIterator(3, data_dir=str(root), **kw)
    t = t_lfw.LFWDataSetIterator(3, data_dir=str(root), **kw)
    while j.has_next():
        a, b = j.next(), t.next()
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert not t.has_next()
