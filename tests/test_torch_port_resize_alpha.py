"""The port's resize (`d3gs_tpu_torch/data/resize.py`) on images with
alpha against Pillow on the CPU: RGBA and LA equal `Image.resize` bit for
bit (Pillow premultiplies them: RGBa / La, resample, convert back), down
and up in size, on one axis or both, with alpha 0, 255 and values in
between; the premultiply and its undo equal Pillow's conversions on every
(value, alpha) pair; gray and RGB stay as they were.
"""
import numpy as np
import pytest

from d3gs_tpu_torch.data.resize import resize
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

# (in height, in width) -> (out height, out width)
SIZES = {"down": ((37, 53), (18, 26)), "down_8": ((81, 121), (10, 15)),
         "up": ((20, 15), (41, 33)), "width_only": ((13, 17), (13, 5)),
         "height_only": ((17, 13), (4, 13)), "mixed": ((30, 12), (9, 40))}


def _image(h, w, ch, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127.5 + 120 * np.sin(xx / (2 + c) + yy / 3.0)
                    for c in range(ch)], -1)
    img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255)
    img = img.astype(np.uint8)
    # alpha: 0, 255, small and mid values in patches
    img[..., -1] = rng.choice([0, 255, 1, 2, 3, 17, 128, 200, 254],
                              (h, w))
    return img


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("mode", ["RGBA", "LA"])
def test_alpha_resize_equals_pillow(mode, size):
    from PIL import Image
    (h, w), (oh, ow) = SIZES[size]
    img = _image(h, w, 4 if mode == "RGBA" else 2, h * w)
    want = np.asarray(Image.fromarray(img, mode).resize((ow, oh)))
    got = resize(img, (ow, oh))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), \
        f"{np.count_nonzero(got != want)} samples differ"


@pytest.mark.parametrize("mode", ["RGBA", "LA"])
def test_premultiply_round_trip_equals_pillow(mode):
    """Every (value, alpha) pair: 2x1 -> 1x1 of two equal pixels returns
    Pillow's un-premultiplied value; (100, 150, 200, 0) -> (0, 0, 0, 0) and
    (100, 150, 200, 3) -> (85, 170, 170, 3)."""
    from PIL import Image
    v, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ch = 4 if mode == "RGBA" else 2
    img = np.stack([v] * (ch - 1) + [a], -1).astype(np.uint8)
    img = img.reshape(-1, 1, ch).repeat(2, 1)              # (65536, 2, ch)
    want = np.asarray(Image.fromarray(img, mode).resize((1, 65536)))
    got = resize(img, (1, 65536))
    assert np.array_equal(got, want)
    if mode == "RGBA":
        px = np.array([[[100, 150, 200, 0]] * 2, [[100, 150, 200, 3]] * 2],
                      np.uint8)
        assert resize(px, (1, 2))[:, 0].tolist() == [[0, 0, 0, 0],
                                                     [85, 170, 170, 3]]


@pytest.mark.parametrize("ch", [1, 3])
def test_gray_and_rgb_unchanged_by_the_alpha_path(ch):
    from PIL import Image
    img = _image(29, 31, max(ch, 2), 5)[..., :ch]
    img = img[..., 0] if ch == 1 else np.ascontiguousarray(img)
    for out in ((14, 15), (29, 7), (60, 61), (31, 29)):
        want = np.asarray(Image.fromarray(img).resize(out))
        assert np.array_equal(resize(img, out), want), out


def test_same_size_returns_a_copy():
    img = _image(6, 7, 4, 0)
    out = resize(img, (7, 6))
    assert out is not img and np.array_equal(out, img)
