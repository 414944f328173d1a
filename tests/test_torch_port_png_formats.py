"""The port's PNG codec (`d3gs_tpu_torch/data/image_io.py`) on the formats
Pillow reads and JAX trains on, against Pillow on the CPU: 16-bit RGB,
RGBA and gray+alpha, 2- and 4-bit gray, 8-bit gray+alpha, and Adam7
interlaced versions of each (and of 8-bit gray, RGB and RGBA) equal
`np.asarray(Image.open(...))` at every size from 1x1 to 9x9 (Adam7 passes
with no rows or columns) and at 37x29; 1-bit gray, 16-bit gray and palette
files raise with their names; `write_png`'s gray+alpha, iCCP and tRNS, and
`read_image(..., info=True)`, equal Pillow's `info`; the Blender and
dynamic360 readers on 16-bit and interlaced frames load what `d3gs_tpu`'s
readers load. Pillow cannot write most of these formats:
tests/torch_port_png_writer.py does.
"""
import io
import os

import numpy as np
import pytest

from d3gs_tpu import config as JC
from d3gs_tpu.data import scene as JS
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch.data import scene as TS
from d3gs_tpu_torch.data.image_io import read_image, read_png, write_png
from tests.test_torch_port_readers import (_blender_set, _transforms_set,
                                           _twin, assert_scenes_equal)
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401
from tests.torch_port_png_writer import chunk, encode_png

# name -> (bit depth, PNG color type)
FORMATS = {"rgb16": (16, 2), "rgba16": (16, 6), "la16": (16, 4),
           "gray2": (2, 0), "gray4": (4, 0), "la8": (8, 4), "gray8": (8, 0),
           "rgb8": (8, 2), "rgba8": (8, 6)}
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _samples(depth, color, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << depth, (h, w, CHANNELS[color]))


def _check(tmp_path, data, what):
    from PIL import Image
    want = np.asarray(Image.open(io.BytesIO(data)))
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(data)
    got = read_png(path)
    assert got.dtype == want.dtype == np.uint8, what
    assert got.shape == want.shape and np.array_equal(got, want), what
    assert np.array_equal(read_image(path), want), what


# tests/test_torch_port_io.py covers non-interlaced 8-bit gray, RGB, RGBA
CASES = [(f, i) for i in (False, True) for f in FORMATS
         if i or f not in ("gray8", "rgb8", "rgba8")]


@pytest.mark.parametrize("fmt,interlace", CASES,
                         ids=[f + ("_adam7" if i else "") for f, i in CASES])
def test_format_equals_pillow(tmp_path, fmt, interlace):
    depth, color = FORMATS[fmt]
    sizes = [(h, w) for h in range(1, 10) for w in range(1, 10)] + [(37, 29)]
    for k, (h, w) in enumerate(sizes):
        data = encode_png(_samples(depth, color, h, w, k), depth, color,
                          interlace=interlace)
        _check(tmp_path, data, f"{fmt} {w}x{h} interlace {interlace}")


@pytest.mark.parametrize("fmt", ["rgba16", "gray2", "la8"])
def test_rows_without_average_or_paeth_equal_pillow(tmp_path, fmt):
    """Only None / Sub / Up rows: the row-by-row path of the unfilter (an
    Average or Paeth row sends the image down the diagonal one)."""
    depth, color = FORMATS[fmt]
    for k, (h, w) in enumerate([(1, 1), (5, 7), (9, 9), (37, 29)]):
        for interlace in (False, True):
            data = encode_png(_samples(depth, color, h, w, k), depth, color,
                              interlace=interlace, filters=(0, 1, 2))
            _check(tmp_path, data, f"{fmt} {w}x{h} interlace {interlace}")


REFUSED = {"gray1": (1, 0, "1-bit gray"), "gray16": (16, 0, "16-bit gray"),
           "palette": (8, 3, "palette")}


@pytest.mark.parametrize("interlace", [False, True], ids=["flat", "adam7"])
@pytest.mark.parametrize("fmt", list(REFUSED))
def test_refused_formats_raise_with_their_names(tmp_path, fmt, interlace):
    depth, color, name = REFUSED[fmt]
    px = np.random.default_rng(0).integers(0, 1 << min(depth, 4), (5, 6, 1))
    extra = chunk(b"PLTE", bytes(range(48))) if color == 3 else b""
    path = str(tmp_path / "r.png")
    with open(path, "wb") as f:
        f.write(encode_png(px, depth, color, interlace=interlace,
                           extra=extra))
    for read in (read_png, read_image):
        with pytest.raises(ValueError, match=f"unsupported PNG \\({name}"):
            read(path)


def _info(path):
    from PIL import Image
    im = Image.open(path)
    return np.asarray(im), {k: im.info[k] for k in ("icc_profile",
                                                    "transparency", "comment")
                            if k in im.info}


ICC = bytes(range(256)) * 3          # any bytes: neither side parses it


@pytest.mark.parametrize("case", ["la", "gray_trns", "rgb_trns_icc",
                                  "rgba_icc"])
def test_write_png_equals_pillow_info(tmp_path, case):
    rng = np.random.default_rng(1)
    img, kw = {
        "la": (rng.integers(0, 256, (7, 9, 2)), {}),
        "gray_trns": (rng.integers(0, 256, (7, 9)), {"transparency": 17}),
        "rgb_trns_icc": (rng.integers(0, 256, (7, 9, 3)),
                         {"transparency": (1, 2, 300), "icc_profile": ICC}),
        "rgba_icc": (rng.integers(0, 256, (7, 9, 4)), {"icc_profile": ICC}),
    }[case]
    img = img.astype(np.uint8)
    path = str(tmp_path / "w.png")
    write_png(path, img, **kw)
    pixels, info = _info(path)
    assert np.array_equal(pixels, img)
    assert info == kw
    got, got_info = read_image(path, info=True)
    assert np.array_equal(got, img) and got_info == kw


def test_write_png_refuses_transparency_with_alpha(tmp_path):
    with pytest.raises(ValueError, match="transparency"):
        write_png(str(tmp_path / "a.png"), np.zeros((2, 2, 4), np.uint8),
                  transparency=3)


@pytest.mark.parametrize("case", ["png_pillow", "png_16bit_trns",
                                  "jpeg_comments_icc", "jpeg_plain"])
def test_read_image_info_equals_pillow(tmp_path, case):
    from PIL import Image
    rng = np.random.default_rng(2)
    path = str(tmp_path / ("i.png" if case.startswith("png") else "i.jpg"))
    rgb = rng.integers(0, 256, (12, 10, 3)).astype(np.uint8)
    if case == "png_pillow":
        Image.fromarray(rgb).save(path, icc_profile=ICC,
                                  transparency=(4, 5, 6))
    elif case == "png_16bit_trns":
        with open(path, "wb") as f:
            f.write(encode_png(rgb.astype(np.uint16) * 257, 16, 2,
                               interlace=True, extra=chunk(
                                   b"tRNS", bytes([1, 2, 3, 4, 5, 6]))))
    elif case == "jpeg_plain":
        Image.fromarray(rgb).save(path)
    else:
        Image.fromarray(rgb).save(path, comment=b"first", icc_profile=ICC)
        with open(path, "rb") as f:            # a second COM: the last wins
            data = f.read()
        com = b"\xff\xfe\x00\x08second"
        with open(path, "wb") as f:
            f.write(data[:2] + com + data[2:data.index(b"\xff\xda")]
                    + com.replace(b"second", b"third!")
                    + data[data.index(b"\xff\xda"):])
    pixels, info = _info(path)
    got, got_info = read_image(path, info=True)
    assert np.array_equal(got, pixels)
    assert got_info == info and (case.endswith("plain") or info)


def _rewrite_frames(root, fmt):
    """Every PNG under root -> the same pixels as 16-bit (v · 257) and / or
    Adam7, the two alternating between frames for 'mixed'."""
    k = 0
    for dirpath, _, names in sorted(os.walk(root)):
        for name in sorted(n for n in names if n.endswith(".png")):
            path = os.path.join(dirpath, name)
            img = read_png(path)
            color = {3: 2, 4: 6}[img.shape[2]]
            wide = fmt != "adam7"
            interlace = fmt.endswith("adam7") or (fmt == "mixed" and k % 2)
            px = img.astype(np.uint16) * 257 if wide else img
            with open(path, "wb") as f:
                f.write(encode_png(px, 16 if wide else 8, color,
                                   interlace=interlace))
            k += 1
    return root


READER_SETS = {
    "blender_16bit": ("16bit", _blender_set),
    "blender_adam7": ("adam7", _blender_set),
    "blender_mixed": ("mixed", _blender_set),
    "dynamic360_16bit_adam7": ("16bit_adam7", lambda root: _transforms_set(
        root, "transforms.json", 3)),
}


@pytest.mark.parametrize("white", [True, False], ids=["white", "black"])
@pytest.mark.parametrize("case", list(READER_SETS))
def test_readers_on_16bit_and_interlaced_frames_match_jax(tmp_path, case,
                                                          white):
    """The slice's parity as a whole: `load_scene_data` on 16-bit RGBA /
    RGB and Adam7 frames gives JAX's images and cameras exactly, and the
    images equal those of the 8-bit set they were made from."""
    fmt, write = READER_SETS[case]
    plain = write(str(tmp_path / "plain"))
    root_j, root_t = _twin(tmp_path, lambda r: _rewrite_frames(write(r),
                                                               fmt))
    kw = dict(eval=True, white_background=white)
    j = JS.load_scene_data(JC.ModelParams(source_path=root_j, **kw))
    t = TS.load_scene_data(TC.ModelParams(source_path=root_t, **kw))
    assert_scenes_equal(t, j, root_t, root_j)
    p = TS.load_scene_data(TC.ModelParams(source_path=plain, **kw))
    for a, b in zip(t.train_cameras + t.test_cameras,
                    p.train_cameras + p.test_cameras):
        assert np.array_equal(a.image, b.image)
