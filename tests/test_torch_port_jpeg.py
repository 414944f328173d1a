"""The port's JPEG decoder (`d3gs_tpu_torch/data/jpeg.py`) against Pillow
on the CPU: bit-equal to `np.asarray(PIL.Image.open(p))` on files Pillow
writes in the test (quality, subsampling, sizes that crop MCUs, grayscale,
RGB, progressive, optimized tables, restart markers, SOF1), on files of
tests/torch_port_jpeg_encoder.py (4:4:0, 4:1:1, one scan per component),
and on the committed fixtures of tests/torch_port_jpeg/; the unsupported
kinds raise ValueError; `image_io.read_image` dispatches on the signature.
"""
import glob
import io
import os

import numpy as np
import pytest

from d3gs_tpu_torch.data.image_io import read_image, write_png
from d3gs_tpu_torch.data.jpeg import decode_jpeg, read_jpeg
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401
from tests.torch_port_jpeg_encoder import encode_baseline

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_port_jpeg")
SIZES = {"33x17": (17, 33), "1x1": (1, 1), "129x65": (65, 129)}


def _image(h, w, seed=0):
    """Smooth structure plus noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (5 + 3 * c) + c) * np.cos(yy / 7.0 - c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 20, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _pillow_bytes(img, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_equals_pillow(data: bytes):
    from PIL import Image
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), \
        f"{np.count_nonzero(got != want)} samples differ, by up to " \
        f"{np.abs(got.astype(int) - want).max()}"


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_matches_pillow(quality, subsampling, size):
    h, w = SIZES[size]
    _assert_equals_pillow(_pillow_bytes(_image(h, w, h * w), quality=quality,
                                        subsampling=subsampling))


# Pillow writes none of these layouts: the test's own encoder does
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("layout", ["440", "411", "440_single_scans",
                                    "mixed"])
def test_matches_pillow_other_sampling(layout, size):
    sampling = {"440": ((1, 2), (1, 1), (1, 1)),
                "440_single_scans": ((1, 2), (1, 1), (1, 1)),
                "411": ((4, 1), (1, 1), (1, 1)),
                "mixed": ((2, 2), (2, 1), (1, 2))}[layout]
    h, w = SIZES[size]
    _assert_equals_pillow(encode_baseline(
        _image(h, w, 7), sampling, interleaved="single" not in layout))


KINDS = {
    "gray": dict(gray=True, quality=90),
    "keep_rgb": dict(keep_rgb=True, subsampling=0, quality=90),
    "progressive": dict(progressive=True, quality=90),
    "progressive_gray": dict(gray=True, progressive=True, quality=75),
    # libjpeg's block smoothing must stay off on a complete file
    "progressive_low_quality": dict(progressive=True, quality=5),
    "progressive_optimized_444": dict(progressive=True, optimize=True,
                                      subsampling=0, quality=60),
    "optimized": dict(optimize=True, quality=75),
    "restart_blocks": dict(restart_marker_blocks=3, quality=90),
    "restart_rows": dict(restart_marker_rows=1, subsampling=1, quality=90),
    "progressive_restart": dict(progressive=True, restart_marker_blocks=5,
                                quality=90),
    "sof1_16bit_tables": dict(qtables=[[300] + [3] * 63, [7] * 64]),
    "quality_1": dict(quality=1),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_matches_pillow_kinds(kind):
    kw = dict(KINDS[kind])
    img = _image(65, 129, 3)
    if kw.pop("gray", False):
        img = img[..., 1]
    _assert_equals_pillow(_pillow_bytes(img, **kw))


def _fixtures():
    return sorted(os.path.basename(p)[:-4]
                  for p in glob.glob(os.path.join(FIXTURES, "*.jpg")))


@pytest.mark.parametrize("name", _fixtures())
def test_fixtures_match_their_pngs(name):
    """The committed JPEGs against the committed PNGs of Pillow's decode
    (what chip_smoke.py holds the card's host to), and Pillow now."""
    from PIL import Image
    jpg = os.path.join(FIXTURES, f"{name}.jpg")
    got = read_jpeg(jpg)
    assert np.array_equal(got, read_image(jpg[:-4] + ".png"))
    assert np.array_equal(got, np.asarray(Image.open(jpg)))


def test_fixture_set_covers_the_kinds():
    from PIL import Image
    names = _fixtures()
    assert len(names) >= 5
    sizes = [np.asarray(Image.open(os.path.join(FIXTURES, f"{n}.jpg")))
             .shape for n in names]
    assert max(h * w for h, w, *_ in sizes) >= 250_000
    with open(os.path.join(FIXTURES, "progressive_444.jpg"), "rb") as f:
        assert b"\xff\xc2" in f.read()


def _unsupported(kind) -> bytes:
    from PIL import Image
    img = _image(24, 40)
    if kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        return buf.getvalue()
    data = _pillow_bytes(img)
    if kind == "truncated":
        return data[:len(data) // 2]
    sof = data.find(b"\xff\xc0")
    if kind == "12bit":
        return data[:sof + 4] + b"\x0c" + data[sof + 5:]
    marker = {"arithmetic": b"\xff\xc9", "lossless": b"\xff\xc3",
              "hierarchical": b"\xff\xc5"}[kind]
    return data[:sof] + marker + data[sof + 2:]


@pytest.mark.parametrize("kind,match", [
    ("cmyk", "CMYK"), ("truncated", "truncated"),
    ("arithmetic", "arithmetic"), ("lossless", "lossless"),
    ("hierarchical", "hierarchical"), ("12bit", "12-bit")])
def test_unsupported_kinds_raise(tmp_path, kind, match):
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(_unsupported(kind))
    with pytest.raises(ValueError, match=match) as e:
        read_image(path)
    assert path in str(e.value)


def test_read_image_dispatches_on_the_signature(tmp_path):
    """A JPEG under a .png name decodes as JPEG (Pillow sniffs too); PNG
    stays PNG; anything else raises."""
    from PIL import Image
    img = _image(9, 11)
    png = str(tmp_path / "a.png")
    write_png(png, img)
    assert np.array_equal(read_image(png), img)
    disguised = str(tmp_path / "b.png")
    with open(disguised, "wb") as f:
        f.write(_pillow_bytes(img))
    assert np.array_equal(read_image(disguised),
                          np.asarray(Image.open(disguised)))
    gif = str(tmp_path / "c.gif")
    Image.fromarray(img).save(gif)
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        read_image(gif)
