"""Plain 3D Gaussian splatting: SH colours, the EWA projection, each
Gaussian's rectangle of 16x16 tiles, and front-to-back compositing per
pixel (the reference rasterizer's preprocessCUDA and renderCUDA, Kerbl et
al. 2023), in plain PyTorch, one row of tiles at a time.

Per pixel p and the Gaussians whose tile rectangle holds p's tile, in
order of view depth (ties by index):

    power   = -0.5 (a dx^2 + c dy^2) - b dx dy,  (dx, dy) = mean2d - p
    alpha   = min(0.99, opacity e^power); skipped if power > 0 or
              alpha < 1/255
    T_after = T (1 - alpha); the walk stops at the first T_after < 1e-4,
              which is not composited
    image   = sum alpha T rgb + T_final bg

Departures from the published code, each the rule of the JAX package the
port follows: the rectangle's extent along each axis is the 1/255 contour's
(sqrt(2 ln(255 opacity) cov_xx)) where that is inside the 3-sigma circle;
its exclusive end is floor((m + r) / 16) + 1; the 2D covariance's
determinant is summed by Cauchy-Binet, which does not cancel in float32.

The gradient of the image (`image_vjp`) is taken by autograd, one block
of tiles at a time, recomputing the block.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

TILE = 16
PIXELS = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
BLOCK_ELEMENTS = 1 << 24      # (tiles, records, pixels) per block

# real spherical harmonics (the reference's utils/sh_utils.py)
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def sh_rgb(features: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(N, 16, 3) coefficients of degree 3, (N, 3) unit directions ->
    (N, 3) colour, clamped at 0 after the +0.5 offset."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    basis = [torch.full_like(x, C0), -C1 * y, C1 * z, -C1 * x,
             C2[0] * xy, C2[1] * yz, C2[2] * (2 * zz - xx - yy),
             C2[3] * xz, C2[4] * (xx - yy),
             C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
             C3[2] * y * (4 * zz - xx - yy),
             C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
             C3[6] * x * (xx - 3 * yy)]
    rgb = sum(b[:, None] * features[:, i] for i, b in enumerate(basis))
    return (rgb + 0.5).clamp_min(0.0)


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz quaternions, normalized here -> (N, 3, 3) rotations."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


class Splats(NamedTuple):
    records: torch.Tensor   # (N, 10) mean2d x, y, conic a, b, c, rgb,
    #                         opacity, depth: differentiable
    rect: torch.Tensor      # (N, 4) int64 tile rectangle x0, y0, x1, y1
    #                         (ends exclusive)
    visible: torch.Tensor   # (N,) bool


def _pix(ndc: torch.Tensor, size: int) -> torch.Tensor:
    return ((ndc + 1.0) * size - 1.0) * 0.5


def project(means: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
            opacity: torch.Tensor, rgb: torch.Tensor, view,
            alive: torch.Tensor) -> Splats:
    """EWA projection of N Gaussians (activated scales, opacity in (0, 1))
    through `view` (scene.View)."""
    width, height = view.width, view.height
    tanx, tany = math.tan(view.fovx / 2), math.tan(view.fovy / 2)
    fx, fy = width / (2 * tanx), height / (2 * tany)
    hom = torch.cat([means, torch.ones_like(means[:, :1])], dim=-1)
    pv = hom @ view.viewmatrix
    ph = hom @ view.projmatrix
    ndc = ph[:, :2] / (ph[:, 3:4] + 1e-7)
    tz = pv[:, 2]
    front = tz > 0.2
    tz_s = torch.where(front, tz, torch.ones_like(tz))
    tx = (pv[:, 0] / tz).clamp(-1.3 * tanx, 1.3 * tanx) * tz
    ty = (pv[:, 1] / tz).clamp(-1.3 * tany, 1.3 * tany) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([fx / tz_s, zero, -fx * tx / (tz_s * tz_s),
                     zero, fy / tz_s, -fy * ty / (tz_s * tz_s)],
                    dim=-1).reshape(-1, 2, 3)
    W = view.viewmatrix[:3, :3].T
    M = (J @ W) @ (rotation(quats) * scales[:, None, :])     # (N, 2, 3)
    a_raw = (M[:, 0] * M[:, 0]).sum(-1)
    c_raw = (M[:, 1] * M[:, 1]).sum(-1)
    b = (M[:, 0] * M[:, 1]).sum(-1)
    minors = torch.stack([
        M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1] * M[:, 1, 0],
        M[:, 0, 0] * M[:, 1, 2] - M[:, 0, 2] * M[:, 1, 0],
        M[:, 0, 1] * M[:, 1, 2] - M[:, 0, 2] * M[:, 1, 1]], dim=-1)
    a, c = a_raw + 0.3, c_raw + 0.3
    det = (minors * minors).sum(-1) + 0.3 * (a_raw + c_raw) + 0.09
    conic = torch.stack([c / det, -b / det, a / det], dim=-1)
    mx, my = _pix(ndc[:, 0], width), _pix(ndc[:, 1], height)

    with torch.no_grad():
        tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
        mid = 0.5 * (a + c)
        sig = torch.sqrt(mid + torch.sqrt((mid * mid - det).clamp_min(0.1)))
        extent = torch.sqrt((2.0 * torch.log(
            opacity.clamp_min(1e-30) * 255.0)).clamp_min(0.0))
        radius = torch.ceil(extent.clamp_max(3.0) * sig)
        rx = torch.minimum(radius, torch.ceil(extent * torch.sqrt(a)))
        ry = torch.minimum(radius, torch.ceil(extent * torch.sqrt(c)))

        def lo(v, r, n):
            v = torch.nan_to_num((v - r) / TILE, nan=0.0)
            return v.clamp(-2.0 ** 31, 2.0 ** 31).long().clamp(0, n)

        def hi(v, r, n):
            v = torch.nan_to_num(torch.floor((v + r) / TILE), nan=0.0)
            return (v.clamp(-2.0 ** 31, 2.0 ** 31).long() + 1).clamp(0, n)

        rect = torch.stack([lo(mx, rx, tiles_x), lo(my, ry, tiles_y),
                            hi(mx, rx, tiles_x), hi(my, ry, tiles_y)], -1)
        visible = (front & (det > 0) & (rect[:, 2] > rect[:, 0])
                   & (rect[:, 3] > rect[:, 1]) & (radius > 0) & alive)
    records = torch.cat([mx[:, None], my[:, None], conic, rgb,
                         opacity[:, None], tz[:, None]], dim=-1)
    return Splats(records, rect, visible)


def _rows(splats: Splats, tiles_x: int, tiles_y: int):
    """Per row of tiles: (ty, ids (tiles_x, K) Gaussian ids in depth
    order, valid (tiles_x, K)), or (ty, None, None) for an empty row."""
    rec = splats.records.detach()
    key = torch.where(splats.visible, rec[:, 9],
                      torch.full_like(rec[:, 9], float("inf")))
    order = torch.argsort(key, stable=True)
    order = order[splats.visible[order]]
    rect = splats.rect[order]
    tx = torch.arange(tiles_x, device=rect.device)
    for ty in range(tiles_y):
        in_row = (rect[:, 1] <= ty) & (ty < rect[:, 3])
        ids, r = order[in_row], rect[in_row]
        member = (r[None, :, 0] <= tx[:, None]) & (tx[:, None] < r[None, :, 2])
        count = member.sum(1)
        k = int(count.max()) if ids.numel() else 0
        if k == 0:
            yield ty, None, None
            continue
        pos = torch.argsort((~member).to(torch.uint8), dim=1,
                            stable=True)[:, :k]
        valid = torch.arange(k, device=rect.device)[None, :] < count[:, None]
        yield ty, ids[pos], valid


def _blocks(splats: Splats, width: int, height: int):
    """(tile x indices, ty, ids, valid) blocks of at most BLOCK_ELEMENTS
    (tile, record, pixel) entries, covering every non-empty tile."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    for ty, ids, valid in _rows(splats, tiles_x, tiles_y):
        if ids is None:
            continue
        step = max(1, BLOCK_ELEMENTS // (ids.shape[1] * PIXELS))
        for x0 in range(0, tiles_x, step):
            sl = slice(x0, min(x0 + step, tiles_x))
            yield (torch.arange(sl.start, sl.stop, device=ids.device), ty,
                   ids[sl], valid[sl])


def _composite(r: torch.Tensor, valid: torch.Tensor, txs: torch.Tensor,
               ty: int, bg: torch.Tensor):
    """Records r (Tc, K, 10) of Tc tiles of row ty -> (colour (Tc, P, 3),
    number of composited (pixel, Gaussian) pairs)."""
    pix = torch.arange(PIXELS, device=r.device)
    px = (txs[:, None] * TILE + pix[None, :] % TILE).to(r.dtype)[:, None, :]
    py = (ty * TILE + pix // TILE).to(r.dtype)[None, None, :]
    dx = r[..., 0:1] - px
    dy = r[..., 1:2] - py
    a, b, c = r[..., 2:3], r[..., 3:4], r[..., 4:5]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    raw = r[..., 8:9] * torch.exp(power.clamp_max(0.0))
    ok = (power <= 0.0) & (raw >= ALPHA_MIN) & valid[..., None]
    alpha = torch.where(ok, raw.clamp_max(ALPHA_MAX), torch.zeros_like(raw))
    keep = 1.0 - alpha
    t_after = torch.cumprod(keep, dim=1)
    t_before = torch.cat([torch.ones_like(t_after[:, :1]),
                          t_after[:, :-1]], dim=1)
    inc = t_after >= T_MIN
    w = torch.where(inc, t_before * alpha, torch.zeros_like(alpha))
    t_final = torch.where(inc, keep, torch.ones_like(keep)).prod(dim=1)
    colour = torch.einsum("tkp,tkc->tpc", w, r[..., 5:8])
    colour = colour + t_final[..., None] * bg
    return colour, int((inc & ok).sum())


def _place(image: torch.Tensor, colour: torch.Tensor, txs, ty: int):
    """Write (Tc, P, 3) tile colours into the (H, W, 3) image."""
    height, width = image.shape[:2]
    tiles = colour.reshape(-1, TILE, TILE, 3)
    y0 = ty * TILE
    for j, tx in enumerate(txs.tolist()):
        x0 = tx * TILE
        h, w = min(TILE, height - y0), min(TILE, width - x0)
        image[y0:y0 + h, x0:x0 + w] = tiles[j, :h, :w]


def _tile_grad(g_image: torch.Tensor, txs, ty: int) -> torch.Tensor:
    """(Tc, P, 3) cotangent of the tiles from the (H, W, 3) one (zero past
    the image's edge)."""
    height, width = g_image.shape[:2]
    out = g_image.new_zeros((len(txs), TILE, TILE, 3))
    y0 = ty * TILE
    for j, tx in enumerate(txs.tolist()):
        x0 = tx * TILE
        h, w = min(TILE, height - y0), min(TILE, width - x0)
        out[j, :h, :w] = g_image[y0:y0 + h, x0:x0 + w]
    return out.reshape(len(txs), PIXELS, 3)


@torch.no_grad()
def image(splats: Splats, width: int, height: int,
          bg: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The (H, W, 3) image and the number of composited pairs."""
    rec = splats.records.detach()
    out = bg.expand(height, width, 3).clone()
    pairs = 0
    for txs, ty, ids, valid in _blocks(splats, width, height):
        colour, n = _composite(rec[ids], valid, txs, ty, bg)
        _place(out, colour, txs, ty)
        pairs += n
    return out, pairs


def image_vjp(splats: Splats, width: int, height: int, bg: torch.Tensor,
              g_image: torch.Tensor) -> torch.Tensor:
    """d<g_image, image> / d records, (N, 10), by autograd over each block
    recomputed."""
    leaf = splats.records.detach().requires_grad_()
    with torch.enable_grad():
        for txs, ty, ids, valid in _blocks(splats, width, height):
            colour, _ = _composite(leaf[ids], valid, txs, ty, bg)
            torch.autograd.backward(colour, _tile_grad(g_image, txs, ty))
    if leaf.grad is None:
        return torch.zeros_like(leaf)
    return leaf.grad


def splat_inputs(params: dict, means: torch.Tensor, d_rot, d_scale,
                 campos: torch.Tensor):
    """(scales, quaternions, opacity, rgb) of the Gaussians at `means`,
    with the deformation's rotation and scale offsets added to the
    activated canonical ones (the deformable renderer's composition)."""
    scales = torch.exp(params["scaling"]) + d_scale
    q = params["rotation"]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    opacity = torch.sigmoid(params["opacity"][:, 0])
    dirs = means - campos[None, :]
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1,
                                           keepdim=True).clamp_min(1e-8)
    feats = torch.cat([params["features_dc"], params["features_rest"]], 1)
    return scales, q + d_rot, opacity, sh_rgb(feats, dirs)


def splats_for(params: dict, alive: torch.Tensor, means: torch.Tensor,
               d_rot, d_scale, view) -> Splats:
    """`project` of the deformed Gaussians through `view`."""
    scales, q, opacity, rgb = splat_inputs(params, means, d_rot, d_scale,
                                           view.campos)
    return project(means, scales, q, opacity, rgb, view, alive)
