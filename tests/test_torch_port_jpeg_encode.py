"""The port's JPEG encoder (`d3gs_tpu_torch/data/jpeg_encode.py`) against
Pillow's save on the CPU: the bytes equal Pillow's
`Image.fromarray(img).save(buf, "JPEG", ...)` for gray and RGB images of
every size from 1 to 70 px a side (each residue mod 16 in both axes), on
noise, smooth, constant and saturated-primary content, at Pillow's default
quality and at qualities 1, 50, 90 and 100, with and without a comment;
the quantisation tables equal Pillow's at every quality; what Pillow cannot
write as JPEG raises; the committed Pillow-written references of
tests/torch_port_jpeg/ (encode/, colmap_pyramid/, rgba/) cover their kinds
and `convert.resize_pyramid` reproduces them.
"""
import io
import os
import shutil

import numpy as np
import pytest

from d3gs_tpu_torch.convert import resize_pyramid
from d3gs_tpu_torch.data.image_io import read_image
from d3gs_tpu_torch.data.jpeg import decode_jpeg
from d3gs_tpu_torch.data.jpeg_encode import (_CHROMA_Q, _LUMA_Q,
                                             encode_jpeg, quant_table)
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

# (height, width): every height 1-70 once, every width 1-70 once
SIZES = [(h, (37 * h) % 70 + 1) for h in range(1, 71)]


def _content(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([np.sin(xx / (3 + 2 * c) + c) * np.cos(yy / 5.0)
                         for c in range(3)], -1)
        return np.clip(127.5 + 120 * base, 0, 255).astype(np.uint8)
    if kind == "constant":
        return np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    # saturated primaries and black / white in blocks of a few pixels
    colours = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [0, 0, 0],
                        [255, 255, 255], [255, 255, 0]], np.uint8)
    cells = rng.integers(0, len(colours), (h // 3 + 1, w // 3 + 1))
    return colours[np.repeat(np.repeat(cells, 3, 0), 3, 1)[:h, :w]]


def _pillow(img, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_same(want: bytes, got: bytes, what):
    if got != want:
        at = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                  min(len(want), len(got)))
        pytest.fail(f"{what}: {len(got)} bytes against Pillow's {len(want)},"
                    f" first difference at byte {at}")


@pytest.mark.parametrize("quality", [None, 1, 50, 90, 100])
@pytest.mark.parametrize("content", ["noise", "smooth", "constant",
                                     "primaries"])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_bytes_equal_pillow(mode, content, quality):
    """quality None: Pillow's default save (what `convert` writes) against
    the encoder's default, 75."""
    kw = {} if quality is None else {"quality": quality}
    for k, (h, w) in enumerate(SIZES):
        img = _content(content, h, w, k)
        if mode == "L":
            img = np.ascontiguousarray(img[..., k % 3])
        _assert_same(_pillow(img, **kw), encode_jpeg(img, **kw),
                     f"{mode} {w}x{h} {content} q{quality}")


COMMENTS = {"bytes": b"d3gs \xff\x00 comment", "str": "a text comment",
            "long": bytes(range(256)) * 40, "empty": b""}


@pytest.mark.parametrize("comment", list(COMMENTS))
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_comment_bytes_equal_pillow(mode, comment):
    for k, (h, w) in enumerate(SIZES[::7]):
        img = _content("smooth", h, w, k)
        if mode == "L":
            img = np.ascontiguousarray(img[..., 1])
        c = COMMENTS[comment]
        _assert_same(_pillow(img, comment=c), encode_jpeg(img, comment=c),
                     f"{mode} {w}x{h} comment {comment}")
    if comment != "empty":
        from PIL import Image
        im = Image.open(io.BytesIO(encode_jpeg(img, comment=c)))
        assert im.info["comment"] == (c.encode() if isinstance(c, str)
                                      else c)


def test_quant_tables_equal_pillow_at_every_quality():
    from PIL import Image
    img = _content("smooth", 16, 16, 0)
    for q in range(1, 101):
        tables = Image.open(io.BytesIO(_pillow(img, quality=q))).quantization
        for tq, base in ((0, _LUMA_Q), (1, _CHROMA_Q)):
            # Pillow reports the tables in natural order
            assert list(tables[tq]) == quant_table(base, q).tolist(), (q, tq)


def test_large_image_round_trips_through_both_decoders():
    """A 0.3 MP image: Pillow's bytes, and the port's decoder reads the
    port's file as Pillow reads it."""
    from PIL import Image
    img = _content("smooth", 480, 640, 3)
    img = np.clip(img.astype(int) + np.random.default_rng(0).normal(
        0, 6, img.shape), 0, 255).astype(np.uint8)
    data = encode_jpeg(img)
    _assert_same(_pillow(img), data, "640x480")
    assert np.array_equal(decode_jpeg(data),
                          np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("bad", ["rgba", "la", "float", "empty"])
def test_what_pillow_cannot_write_raises(bad):
    img = {"rgba": np.zeros((4, 4, 4), np.uint8),
           "la": np.zeros((4, 4, 2), np.uint8),
           "float": np.zeros((4, 4, 3), np.float32),
           "empty": np.zeros((0, 4, 3), np.uint8)}[bad]
    with pytest.raises(ValueError, match="encode_jpeg"):
        encode_jpeg(img)


FIXTURES = os.path.join(os.path.dirname(__file__), "torch_port_jpeg")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def test_encoder_fixture_set_covers_the_kinds():
    """The references chip_smoke.py phase 4n holds the port to (written by
    tests/torch_port_jpeg/make_fixtures.py with Pillow): the 0.256 MP
    encode, the 18 pyramid JPEGs of the six COLMAP views at 80x60, 40x30
    and 20x15, the RGBA set and its 9 pyramid PNGs; Pillow still writes
    them so."""
    from PIL import Image
    img = read_image(os.path.join(FIXTURES, "render_420.png"))
    assert img.shape[0] * img.shape[1] >= 250_000
    with open(os.path.join(FIXTURES, "encode", "render_420_q75.jpg"),
              "rb") as f:
        assert f.read() == encode_jpeg(img) == _pillow(img)
    pyramid = _files(os.path.join(FIXTURES, "colmap_pyramid"))
    assert pyramid == [f"images_{d}/{k}.jpg" for d in (2, 4, 8)
                       for k in range(6)]
    sizes = {Image.open(os.path.join(FIXTURES, "colmap_pyramid", p)).size
             for p in pyramid}
    assert sizes == {(80, 60), (40, 30), (20, 15)}
    rgba = _files(os.path.join(FIXTURES, "rgba"))
    assert rgba == [f"images_{d}/{k}.png" for d in (2, 4, 8)
                    for k in range(3)] + [f"input/{k}.png" for k in range(3)]
    alphas = np.concatenate([np.asarray(Image.open(os.path.join(
        FIXTURES, "rgba", "input", f"{k}.png")))[..., 3].ravel()
        for k in range(3)])
    assert {0, 255} <= set(alphas.tolist()) and ((alphas > 0)
                                                 & (alphas < 255)).any()


@pytest.mark.parametrize("kind", ["colmap_jpeg", "rgba_png"])
def test_resize_pyramid_equals_the_committed_pillow_pyramid(tmp_path, kind):
    """`convert.resize_pyramid` on the committed sets: the JPEGs equal
    Pillow's byte for byte, the RGBA PNGs its pixels."""
    images, ref = {"colmap_jpeg": ("colmap/images", "colmap_pyramid"),
                   "rgba_png": ("rgba/input", "rgba")}[kind]
    src = str(tmp_path / "src")
    shutil.copytree(os.path.join(FIXTURES, images),
                    os.path.join(src, "images"))
    resize_pyramid(src)
    names = [p for p in _files(os.path.join(FIXTURES, ref))
             if p.startswith("images_")]
    assert names and _files(src) == sorted(
        names + [f"images/{n}" for n in os.listdir(os.path.join(src,
                                                                "images"))])
    for name in names:
        want_path = os.path.join(FIXTURES, ref, name)
        got_path = os.path.join(src, name)
        if kind == "colmap_jpeg":
            with open(want_path, "rb") as a, open(got_path, "rb") as b:
                assert a.read() == b.read(), name
        else:
            assert np.array_equal(read_image(got_path),
                                  read_image(want_path)), name
