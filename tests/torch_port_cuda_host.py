"""Build a kernel source of `d3gs_tpu_torch/csrc` for the CPU: a text edit
of the .cu (the cp.async helpers as plain copies, `extern __shared__` as
the block's buffer, `<<<...>>>` launches as `host_launch`) compiled by g++
against the stand-in runtime of `tests/cuda_host/cuda_runtime.h`, and
loaded with ctypes. Its C entry then runs on CPU tensors' pointers, so a
test holds the kernel's own arithmetic against its plain version here;
the card runs it in `chip_smoke.py`."""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "d3gs_tpu_torch" / "csrc"


def host_source(text: str) -> str:
    """The .cu's text with the device-only constructs replaced."""
    def body(name: str, new: str) -> None:
        nonlocal text
        pat = (r"(__device__ __forceinline__ void " + name
               + r"\([^)]*\) \{).*?\n\}")
        text, n = re.subn(pat, r"\1 " + new + " }", text, flags=re.S)
        if n != 1:
            raise ValueError(f"{name}: {n} definitions")
    body("cp_async16", "std::memcpy(smem, gmem, 16);")
    body("cp_async_commit", "")
    body("cp_async_wait", "")
    text = text.replace("extern __shared__ __align__(16) float smem[];",
                        "float* smem = host_smem();")

    def launch(m: re.Match) -> str:
        cfg = [p.strip() for p in m.group(2).split(",")]
        smem = cfg[2] if len(cfg) > 2 else "0"
        return (f"host_launch({cfg[0]}, {cfg[1]}, {smem}, [&] {{ "
                f"{m.group(1)}({m.group(3)}); }});")
    return re.sub(r"([\w:]+(?:<[^<>]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  launch, text, flags=re.S)


def compiler() -> str | None:
    return shutil.which("g++")


def build(name: str, out_dir: Path) -> ctypes.CDLL:
    """lib<name>.so for the CPU from csrc/<name>.cu, built in out_dir."""
    src = out_dir / f"{name}.cpp"
    src.write_text(host_source((CSRC / f"{name}.cu").read_text()))
    lib = out_dir / f"lib{name}.so"
    subprocess.run([compiler(), "-std=c++20", "-O2", "-shared", "-fPIC",
                    "-pthread", "-I", str(HERE / "cuda_host"), "-o",
                    str(lib), str(src)], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(str(lib))
