"""The port's COLMAP preprocessing CLI (`d3gs_tpu_torch.convert`) against
the repository's `convert.py` on the CPU, with a fake `colmap` on PATH that
records its argv and writes what `image_undistorter` would: both CLIs run
the same commands in the same order and leave the same tree. With --resize
the pyramid is Pillow's on RGB, RGBA, gray+alpha and gray PNG sets and on
PNG sets with an ICC profile and tRNS transparency (pixels and Pillow's
`info` equal), and on RGB, gray and commented JPEG sets (the files equal
byte for byte); RGBA or gray+alpha under a JPEG name raises as Pillow's
save does; a JPEG set without --resize runs the four commands; a missing
executable and a failing command exit with the JAX CLI's codes.
"""
import json
import os
import shutil

import numpy as np
import pytest

import convert as jax_convert
from d3gs_tpu_torch import convert as port_convert
from d3gs_tpu_torch.data.image_io import read_image, write_png
from tests.torch_port_fake_colmap import write_fake_colmap
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


@pytest.fixture
def colmap(tmp_path, monkeypatch):
    """A fake `colmap` first on PATH; -> the file its argv lines go to."""
    bin_dir = tmp_path / "bin"
    write_fake_colmap(str(bin_dir))
    log = tmp_path / "colmap.log"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_COLMAP_LOG", str(log))
    return log


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (4 + c)) * np.cos(yy / 6.0)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 15, (h, w, 3)), 0,
                   255).astype(np.uint8)


ICC = bytes(range(200)) * 2


def _source(root, fmt="png"):
    """<root>/input with three images of odd sizes in the format `fmt`."""
    from PIL import Image
    os.makedirs(os.path.join(root, "input"))
    for k, (h, w) in enumerate([(37, 53), (40, 64), (81, 17)]):
        img = _image(h, w, k)
        alpha = np.random.default_rng(k).choice([0, 255, 3, 90, 200], (h, w))
        path = os.path.join(root, "input", f"{k}.png")
        if fmt == "png":
            write_png(path, img)
        elif fmt == "rgba_png":
            write_png(path, np.dstack([img, alpha]).astype(np.uint8))
        elif fmt == "la_png":
            write_png(path, np.dstack([img[..., 1], alpha]).astype(np.uint8))
        elif fmt == "icc_trns_png":
            # RGB with a colour key, and gray with a gray key, both with ICC
            im = Image.fromarray(img) if k != 1 else \
                Image.fromarray(img[..., 0])
            im.save(path, icc_profile=ICC,
                    transparency=(1, 2, 3) if k != 1 else 7)
        else:
            gray = fmt == "jpg_gray"
            im = Image.fromarray(img[..., 2] if gray else img)
            kw = {"comment": f"view {k}"} if fmt == "jpg_comment" else {}
            im.save(os.path.join(root, "input", f"{k}.jpg"), quality=90,
                    **kw)
    return root


def _run(main, src, flags, log):
    """-> (the recorded commands with the source path made generic, the
    CLI's exit code)."""
    if log.exists():
        log.unlink()
    code = 0
    try:
        main(["-s", src, *flags])
    except SystemExit as e:
        code = e.code
    lines = log.read_text().splitlines() if log.exists() else []
    return [[a.replace(src, "<src>") for a in json.loads(ln)]
            for ln in lines], code


def _tree(root):
    """Relative path -> bytes; a PNG -> (Pillow's pixels, the `info`
    entries that the pyramid carries over)."""
    from PIL import Image
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".png"):
                im = Image.open(path)
                out[rel] = (np.asarray(im), {
                    k: im.info[k] for k in ("icc_profile", "transparency")
                    if k in im.info})
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


# case -> (flags, the input images' format)
CASES = {"defaults": ([], "png"),
         "no_gpu_camera": (["--no_gpu", "--camera", "PINHOLE"], "png"),
         "skip_matching": (["--skip_matching"], "png"),
         "resize": (["--resize"], "png"),
         "resize_jpeg": (["--resize"], "jpg"),
         "resize_jpeg_gray": (["--resize"], "jpg_gray"),
         "resize_jpeg_comment": (["--resize", "--skip_matching"],
                                 "jpg_comment"),
         "resize_rgba_png": (["--resize"], "rgba_png"),
         "resize_la_png": (["--resize"], "la_png"),
         "resize_icc_trns_png": (["--resize"], "icc_trns_png")}


@pytest.mark.parametrize("case", list(CASES))
def test_same_commands_and_tree_as_jax(tmp_path, colmap, case):
    flags, fmt = CASES[case]
    src_j = _source(str(tmp_path / "j"), fmt)
    src_t = str(tmp_path / "t")
    shutil.copytree(src_j, src_t)
    if "--skip_matching" in flags:
        for src in (src_j, src_t):
            os.makedirs(os.path.join(src, "distorted", "sparse", "0"))
    cmds_j, code_j = _run(jax_convert.main, src_j, flags, colmap)
    cmds_t, code_t = _run(port_convert.main, src_t, flags, colmap)
    assert code_t == code_j == 0
    assert cmds_t == cmds_j
    assert [c[0] for c in cmds_t][-1] == "image_undistorter"
    tree_j, tree_t = _tree(src_j), _tree(src_t)
    assert sorted(tree_t) == sorted(tree_j)
    for rel, want in tree_j.items():
        got = tree_t[rel]
        if isinstance(want, tuple):
            assert got[0].shape == want[0].shape, rel
            assert np.array_equal(got[0], want[0]), rel
            assert got[1] == want[1], rel
        else:
            assert got == want, rel          # JPEG and the rest: the bytes
    assert sorted(os.listdir(os.path.join(src_t, "sparse", "0"))) == [
        "cameras.bin", "images.bin", "points3D.bin"]
    if "--resize" in flags:
        ext = ".jpg" if fmt.startswith("jpg") else ".png"
        pyramid = [r for r in tree_t if r.startswith("images_")]
        assert len(pyramid) == 9 and all(r.endswith(ext) for r in pyramid)
        img = read_image(os.path.join(src_t, "images_4", "0" + ext))
        assert img.shape[:2] == (37 // 4, 53 // 4)
        if fmt == "jpg_comment":
            assert read_image(os.path.join(src_t, "images_8", "2.jpg"),
                              info=True)[1] == {"comment": b"view 2"}
        if fmt == "icc_trns_png":
            assert tree_t[os.path.join("images_2", "1.png")][1] == {
                "icc_profile": ICC, "transparency": 7}


def test_jpeg_set_without_resize_runs_the_four_commands(tmp_path, colmap):
    src = _source(str(tmp_path / "s"), fmt="jpg")
    cmds, code = _run(port_convert.main, src, [], colmap)
    assert code == 0 and len(cmds) == 4


@pytest.mark.parametrize("mode", ["RGBA", "LA"])
def test_alpha_under_a_jpeg_name_raises_as_pillow(tmp_path, colmap, mode):
    """An RGBA or gray+alpha PNG named .jpg: Pillow's JPEG save refuses
    it, and so does the port, with Pillow's message, after the commands."""
    root = str(tmp_path / mode)
    os.makedirs(os.path.join(root, "input"))
    img = _image(20, 24, 0)
    img = np.dstack([img if mode == "RGBA" else img[..., 0],
                     np.full((20, 24), 200)]).astype(np.uint8)
    write_png(os.path.join(root, "input", "0.jpg"), img)
    src_t = str(tmp_path / (mode + "_t"))
    shutil.copytree(root, src_t)
    msgs = []
    for main, src in ((jax_convert.main, root), (port_convert.main, src_t)):
        with pytest.raises(OSError) as err:
            main(["-s", src, "--resize"])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == f"cannot write mode {mode} as JPEG"
    assert len(colmap.read_text().splitlines()) == 8


def test_exit_codes_match_jax(tmp_path, colmap, monkeypatch):
    src_j = _source(str(tmp_path / "j"))
    src_t = str(tmp_path / "t")
    shutil.copytree(src_j, src_t)
    monkeypatch.setenv("FAKE_COLMAP_FAIL", "exhaustive_matcher")
    cmds_j, code_j = _run(jax_convert.main, src_j, [], colmap)
    cmds_t, code_t = _run(port_convert.main, src_t, [], colmap)
    assert code_t == code_j == 3 and cmds_t == cmds_j and len(cmds_t) == 2
    missing = ["--colmap_executable", "no-such-colmap-here"]
    assert _run(jax_convert.main, src_j, missing, colmap)[1] == \
        _run(port_convert.main, src_t, missing, colmap)[1] == 1
