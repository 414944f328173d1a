"""The port's COLMAP preprocessing CLI (`d3gs_tpu_torch.convert`) against
the repository's `convert.py` on the CPU, with a fake `colmap` on PATH that
records its argv and writes what `image_undistorter` would: both CLIs run
the same commands in the same order and leave the same tree; --resize on a
PNG set equals Pillow's bicubic pyramid bit for bit; --resize on a JPEG
set raises before any command (the port has no JPEG encoder); a missing
executable and a failing command exit with the JAX CLI's codes.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest

import convert as jax_convert
from d3gs_tpu_torch import convert as port_convert
from d3gs_tpu_torch.data.image_io import read_image, write_png
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

FAKE_COLMAP = f"""#!{sys.executable}
import json, os, shutil, sys
with open(os.environ["FAKE_COLMAP_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if sys.argv[1] == os.environ.get("FAKE_COLMAP_FAIL"):
    sys.exit(3)
if sys.argv[1] == "image_undistorter":
    a = dict(zip(sys.argv[2::2], sys.argv[3::2]))
    out = a["--output_path"]
    shutil.copytree(a["--image_path"], os.path.join(out, "images"))
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(out, "sparse", name), "wb") as f:
            f.write(name.encode())
"""


@pytest.fixture
def colmap(tmp_path, monkeypatch):
    """A fake `colmap` first on PATH; -> the file its argv lines go to."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "colmap"
    exe.write_text(FAKE_COLMAP)
    exe.chmod(0o755)
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


def _source(root, fmt="png"):
    """<root>/input with three images of odd sizes."""
    from PIL import Image
    os.makedirs(os.path.join(root, "input"))
    for k, (h, w) in enumerate([(37, 53), (40, 64), (81, 17)]):
        img = _image(h, w, k)
        if fmt == "png":
            write_png(os.path.join(root, "input", f"{k}.png"), img)
        else:
            Image.fromarray(img).save(os.path.join(root, "input",
                                                   f"{k}.jpg"), quality=90)
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
    """Relative path -> decoded pixels (images) or bytes."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith((".png", ".jpg")):
                out[rel] = read_image(path)
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


FLAGS = {"defaults": [], "no_gpu_camera": ["--no_gpu", "--camera", "PINHOLE"],
         "skip_matching": ["--skip_matching"],
         "resize": ["--resize"]}


@pytest.mark.parametrize("case", list(FLAGS))
def test_same_commands_and_tree_as_jax(tmp_path, colmap, case):
    src_j = _source(str(tmp_path / "j"))
    src_t = str(tmp_path / "t")
    shutil.copytree(src_j, src_t)
    if case == "skip_matching":
        for src in (src_j, src_t):
            os.makedirs(os.path.join(src, "distorted", "sparse", "0"))
    cmds_j, code_j = _run(jax_convert.main, src_j, FLAGS[case], colmap)
    cmds_t, code_t = _run(port_convert.main, src_t, FLAGS[case], colmap)
    assert code_t == code_j == 0
    assert cmds_t == cmds_j
    assert [c[0] for c in cmds_t][-1] == "image_undistorter"
    tree_j, tree_t = _tree(src_j), _tree(src_t)
    assert sorted(tree_t) == sorted(tree_j)
    for rel, want in tree_j.items():
        got = tree_t[rel]
        if isinstance(want, np.ndarray):
            assert got.shape == want.shape and np.array_equal(got, want), rel
        else:
            assert got == want, rel
    assert sorted(os.listdir(os.path.join(src_t, "sparse", "0"))) == [
        "cameras.bin", "images.bin", "points3D.bin"]
    if case == "resize":
        img = tree_t[os.path.join("images_4", "0.png")]
        assert img.shape == (37 // 4, 53 // 4, 3)


def test_resize_on_a_jpeg_set_raises_before_any_command(tmp_path, colmap):
    src = _source(str(tmp_path / "s"), fmt="jpg")
    with pytest.raises(ValueError, match="JPEG encoder"):
        port_convert.main(["-s", src, "--resize"])
    assert not colmap.exists()
    # without --resize the JPEG set converts as in JAX
    cmds, code = _run(port_convert.main, src, [], colmap)
    assert code == 0 and len(cmds) == 4


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
