"""The port's file formats against the JAX package's: the stdlib PNG codec
against Pillow/imageio (decoded pixels byte-exact), and PLY checkpoints
written by `d3gs_tpu.data.scene.save_gaussians_ply`."""
import io
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from d3gs_tpu.data.ply import read_ply
from d3gs_tpu.data.scene import load_gaussians_ply, save_gaussians_ply
from d3gs_tpu.models import gaussians as G
from d3gs_tpu_torch.data import image_io, ply
from d3gs_tpu_torch.data.scene import load_gaussians_ply as t_load

SHAPES = [(37, 23), (37, 23, 3), (37, 23, 4)]


def _img(shape, seed=0):
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(-3, 4, shape), axis=1)   # filters pay off
    return (smooth % 256).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES, ids=len)
def test_png_write_read_by_pil(tmp_path, shape):
    img = _img(shape)
    path = str(tmp_path / "a.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(image_io.read_png(path), img)


@pytest.mark.parametrize("shape", SHAPES, ids=len)
def test_png_read_pil_and_imageio_files(tmp_path, shape):
    import imageio.v2 as imageio
    img = _img(shape, seed=1)
    for opt in (dict(optimize=True), dict(compress_level=1)):
        Image.fromarray(img).save(tmp_path / "p.png", **opt)
        np.testing.assert_array_equal(
            image_io.read_png(str(tmp_path / "p.png")), img)
    imageio.imwrite(tmp_path / "i.png", img)
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "i.png")),
                                  img)


def _png_with_filters(img: np.ndarray) -> bytes:
    """RGB PNG whose rows cycle through filter types 0-4 (encoder written
    out here, independent of the port)."""
    h, w, c = img.shape
    x = img.astype(np.int32).reshape(h, w * c)
    rows = []
    for y in range(h):
        f = y % 5
        up = x[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), x[y, :-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([f]) + ((x[y] - pred) % 256).astype(np.uint8)
                    .tobytes())

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(
            ">I", zlib.crc32(t + b))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_all_row_filters(tmp_path):
    img = _img((25, 19, 3), seed=2)
    data = _png_with_filters(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    (tmp_path / "f.png").write_bytes(data)
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "f.png")),
                                  img)


def test_png_rejects_unsupported(tmp_path):
    Image.fromarray(_img((8, 8, 3))).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="unsupported PNG"):
        image_io.read_png(str(tmp_path / "p.png"))


def _jax_state(n=300, cap=1024, seed=0):
    rng = np.random.default_rng(seed)
    st = G.create_from_pcd(rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                           rng.random((n, 3)).astype(np.float32),
                           sh_degree=3, capacity=cap)
    p = st.params
    return st.replace(params=p._replace(
        features_rest=jnp.asarray(rng.normal(0, 0.05, p.features_rest.shape),
                                  jnp.float32),
        rotation=jnp.asarray(rng.normal(size=p.rotation.shape), jnp.float32),
        opacity=jnp.asarray(rng.normal(size=p.opacity.shape), jnp.float32)))


def test_gaussian_ply_from_jax(tmp_path):
    path = str(tmp_path / "point_cloud.ply")
    save_gaussians_ply(path, _jax_state())
    ref = load_gaussians_ply(path, sh_degree=3)
    got = t_load(path, sh_degree=3, device="cpu")
    for name, v in ref.params._asdict().items():
        np.testing.assert_array_equal(getattr(got.params, name).numpy(),
                                      np.asarray(v), err_msg=name)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
    assert got.active_sh_degree == int(ref.active_sh_degree) == 3
    assert got.max_sh_degree == ref.max_sh_degree

    cols, names = ply.read_ply_columns(path)
    jv, jnames = read_ply(path)
    assert names == jnames
    for k in names:
        np.testing.assert_array_equal(cols[k], jv[k])


def test_pointcloud_ply_roundtrip_read_by_jax(tmp_path):
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 256, (50, 3))
    path = str(tmp_path / "pc.ply")
    ply.write_pointcloud_ply(path, xyz, rgb)
    from d3gs_tpu.data.ply import read_pointcloud_ply
    for a, b in zip(ply.read_pointcloud_ply(path), read_pointcloud_ply(path)):
        np.testing.assert_array_equal(a, b)


def test_gaussian_ply_from_port_loads_in_jax(tmp_path):
    """The port's PLY writer (used to build the on-card smoke's model
    directory) produces what the JAX loader reads back exactly."""
    from d3gs_tpu_torch.data.scene import save_gaussians_ply as t_save
    src = str(tmp_path / "jax.ply")
    save_gaussians_ply(src, _jax_state(seed=3))
    state = t_load(src, sh_degree=3, device="cpu")
    out = str(tmp_path / "port.ply")
    t_save(out, state)
    ref, got = load_gaussians_ply(src), load_gaussians_ply(out)
    for name, v in ref.params._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(got.params, name)),
                                      np.asarray(v), err_msg=name)
    np.testing.assert_array_equal(np.asarray(got.alive), np.asarray(ref.alive))
