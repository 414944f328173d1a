"""Label-map generation for the SAM-regularized trainer (counterpart of
`d3gs_tpu/train/segment.py`; numpy, a copy).

The reference generates SAM2 automatic masks per training image and caches
them to `<source_path>/sam_masks_cache/<image_name>_mask.npy`
(train_baseline_sam.py:34-43,177-198). This module reproduces that flow:

  * **SAM2** when the `sam2` package and a checkpoint (`SAM2_CHECKPOINT`)
    are available (generator settings points_per_side=8,
    points_per_batch=128); its boolean masks are cached in the reference
    layout and turned into the int32 label map the regularizer reads
    (sam_reg.py);
  * **SLIC superpixels** otherwise: k-means over (colour·compactness,
    position/S) features (Achanta et al. 2012), coherent object-part
    regions.

SLIC entries of the cache hold the (H, W) int32 label map, SAM2 entries the
(M, H, W) bool stack; the loader tells them apart by ndim. `tqdm` is used
where it imports.
"""
from __future__ import annotations

import os

import numpy as np


def try_sam2_generator():
    """Build a SAM2 automatic mask generator if the package + checkpoint
    are available (reference initialize_sam_model, :34-43); else None."""
    try:
        from sam2.automatic_mask_generator import \
            SAM2AutomaticMaskGenerator  # type: ignore
        from sam2.build_sam import build_sam2  # type: ignore
    except Exception:
        return None
    ckpt = os.environ.get("SAM2_CHECKPOINT", "")
    cfg = os.environ.get("SAM2_MODEL_CFG", "sam2.1_hiera_b+.yaml")
    if not ckpt or not os.path.exists(ckpt):
        return None
    model = build_sam2(cfg, ckpt, device="cpu", apply_postprocessing=False)
    return SAM2AutomaticMaskGenerator(model, points_per_side=8,
                                      points_per_batch=128)


def slic_label_map(image: np.ndarray, n_segments: int = 64,
                   n_iter: int = 5, compactness: float = 10.0) -> np.ndarray:
    """SLIC superpixels on an (H, W, 3) float image in [0, 1].

    Standard formulation: cluster centers start on a √n_segments grid with
    interval S; each iteration assigns pixels within each center's 2S×2S
    window by distance d = ||rgb·m|| + ||xy||/S·compactness and re-centers.
    Returns an (H, W) int32 label map with labels 1..K (0 is reserved for
    "background / no mask" by the regularizer's convention)."""
    h, w, _ = image.shape
    grid = max(1, int(round(np.sqrt(n_segments))))
    s_y, s_x = h / grid, w / grid
    cy = (np.arange(grid) + 0.5) * s_y
    cx = (np.arange(grid) + 0.5) * s_x
    centers_yx = np.stack(np.meshgrid(cy, cx, indexing="ij"),
                          -1).reshape(-1, 2)
    idx = np.clip(centers_yx.astype(np.int64), 0,
                  [h - 1, w - 1])
    centers_rgb = image[idx[:, 0], idx[:, 1]]
    k = centers_yx.shape[0]
    s = max(s_y, s_x)
    col_w = compactness * 4.0           # color weight vs position/S
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    labels = np.zeros((h, w), np.int32)
    for _ in range(n_iter):
        best = np.full((h, w), np.inf, np.float32)
        for ci in range(k):
            y0 = max(0, int(centers_yx[ci, 0] - s * 1.5))
            y1 = min(h, int(centers_yx[ci, 0] + s * 1.5) + 1)
            x0 = max(0, int(centers_yx[ci, 1] - s * 1.5))
            x1 = min(w, int(centers_yx[ci, 1] + s * 1.5) + 1)
            if y0 >= y1 or x0 >= x1:
                continue
            dc = np.sum((image[y0:y1, x0:x1] - centers_rgb[ci]) ** 2, -1)
            dy = (yy[y0:y1, x0:x1] - centers_yx[ci, 0]) / s
            dx = (xx[y0:y1, x0:x1] - centers_yx[ci, 1]) / s
            d = col_w * dc + dy * dy + dx * dx
            m = d < best[y0:y1, x0:x1]
            best[y0:y1, x0:x1] = np.where(m, d, best[y0:y1, x0:x1])
            labels[y0:y1, x0:x1] = np.where(m, ci, labels[y0:y1, x0:x1])
        # re-center
        for ci in range(k):
            mask = labels == ci
            if mask.any():
                centers_yx[ci] = [yy[mask].mean(), xx[mask].mean()]
                centers_rgb[ci] = image[mask].mean(axis=0)
    return (labels + 1).astype(np.int32)


def masks_to_label_map(masks: np.ndarray, num_masks: int) -> np.ndarray:
    """(M, H, W) bool stack -> (H, W) int32 label map, labels 1..M.
    Larger masks are painted first so smaller (foreground) objects win
    overlaps; at most num_masks labels."""
    m = np.asarray(masks)
    if m.ndim == 2:
        return np.clip(m, 0, num_masks).astype(np.int32)
    areas = m.reshape(m.shape[0], -1).sum(axis=1)
    order = np.argsort(-areas)[:num_masks]
    out = np.zeros(m.shape[1:], np.int32)
    for li, mi in enumerate(order):
        out[m[mi]] = li + 1
    return out


def load_or_generate_label_maps(cams, source_path: str, num_masks: int = 64,
                                method: str = "auto",
                                progress: bool = True) -> dict:
    """Per-camera label maps with the reference's cache flow: load
    `<source>/sam_masks_cache/<image_name>_mask.npy` when present, else
    segment the raw training image (SAM2 when available and method allows,
    SLIC otherwise) and cache it. Returns {image_name: (H, W) int32}."""
    cache_dir = os.path.join(source_path, "sam_masks_cache")
    os.makedirs(cache_dir, exist_ok=True)
    gen = try_sam2_generator() if method in ("auto", "sam2") else None
    if method == "sam2" and gen is None:
        raise RuntimeError("--segmenter sam2 requested but the sam2 "
                           "package/checkpoint is unavailable (set "
                           "SAM2_CHECKPOINT)")
    out = {}
    it = cams
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(cams, desc="Loading/Generating masks")
        except ImportError:
            pass
    for cam in it:
        cache_path = os.path.join(cache_dir, f"{cam.image_name}_mask.npy")
        if os.path.exists(cache_path):
            cached = np.load(cache_path, allow_pickle=True)
            out[cam.image_name] = masks_to_label_map(
                np.asarray(cached), num_masks)
            continue
        img = cam.image.detach().cpu().numpy().astype(np.float32)
        if gen is not None:
            res = gen.generate((img * 255).astype(np.uint8))
            masks = np.stack([r["segmentation"] for r in res]) \
                if res else np.zeros((0,) + img.shape[:2], bool)
            np.save(cache_path, masks)
            out[cam.image_name] = masks_to_label_map(masks, num_masks)
        else:
            lab = slic_label_map(img, n_segments=num_masks)
            np.save(cache_path, lab)
            out[cam.image_name] = np.clip(lab, 0, num_masks).astype(np.int32)
    return out
