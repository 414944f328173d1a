"""CLI: PSNR / SSIM / LPIPS over rendered test sets (counterpart of the
repository's `metrics.py`, the reference's metrics.py:100-110).

    python -m d3gs_tpu_torch.metrics -m <model_dir> [<model_dir> ...]
        [--device cuda|cpu]

Writes results.json and per_view.json into each model directory. LPIPS
reads its VGG weights from the npz that LPIPS_WEIGHTS names (or
./lpips_vgg.npz) and is null without one (`render_eval/lpips.py`).
"""
from __future__ import annotations

import argparse

from . import resolve_device


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="PSNR/SSIM/LPIPS of rendered test sets (PyTorch port)")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from .render_eval.metrics import evaluate_model_paths
    results = evaluate_model_paths(args.model_paths, device=device)
    for mp, res in results.items():
        print(f"\nScene: {mp}")
        for method, vals in res.items():
            print(f"  {method}: PSNR {vals['PSNR']:.4f}  "
                  f"SSIM {vals['SSIM']:.4f}  "
                  f"LPIPS {vals['LPIPS'] if vals['LPIPS'] is not None else 'n/a'}")
    return results


if __name__ == "__main__":
    main()
