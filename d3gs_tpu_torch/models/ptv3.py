"""Point Transformer V3 in PyTorch (counterpart of `d3gs_tpu/models/ptv3.py`,
the flax re-design of the reference's vendored Pointcept model; dormant
there too: no training path imports it).

Same public names and defaults: the z-order and Hilbert curves in four
orders (z, z-trans, hilbert, hilbert-trans) alternated across blocks,
serialized windowed attention over patches of the curve-sorted order, a
depthwise xCPE along the curve, grid pooling / unpooling with skips,
PDNorm and DropPath.

What the flax model computes is kept where a plain port would differ:
- every level keeps the capacity-N buffers with an alive mask. Dead rows
  sort last and are exactly zero, so the xCPE's right neighbour of the
  last alive row is a zero row whenever the level has a dead row (pooled
  levels do as soon as one cell merged), and the row itself only when all
  rows are alive;
- stable sorts: points that share a voxel share a code and keep index
  order, on the card too;
- the attention mask is key-only and masked logits take the dtype's most
  negative value, so a patch of dead or padding rows gets a uniform,
  finite softmax (explicit einsum attention; `scaled_dot_product_attention`
  or a -inf fill would give NaN there);
- flax's conventions: LayerNorm with epsilon 1e-6 and the fast variance
  E[x²] - E[x]² (clipped at 0), the tanh GELU, the query divided by √D,
  PDNorm with its own epsilon 1e-6 and E[(x - μ)²];
- `grid_pool` sums integer coordinates in f32 and truncates the mean.

`forward(feats, grid, mask, *, deterministic=True, condition=0,
generator=None)`: training mode (`deterministic=False`) takes its DropPath
draws and each stage's order permutation from `generator`.
`ptv3_from_flax(params, **config)` carries a flax parameter tree across.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

LN_EPS = 1e-6                    # flax nn.LayerNorm's epsilon
_BIG = 2 ** 31 - 1               # the dead rows' sort key (int32 max)
_ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


# ---------------------------------------------------------------------------
# serialization curves
# ---------------------------------------------------------------------------

def z_order_encode(grid: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """(N, 3) non-negative int grid coords -> (N,) int64 Morton codes,
    `depth` bits per axis (x highest within each triple)."""
    x = grid.long()
    code = torch.zeros(grid.shape[:-1], dtype=torch.long, device=grid.device)
    for b in range(depth):
        for i in range(3):
            code |= ((x[..., i] >> b) & 1) << (3 * b + (2 - i))
    return code


def hilbert_encode(grid: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """(N, 3) grid coords -> (N,) int64 Hilbert indices (Skilling's
    transpose algorithm, vectorised over points)."""
    n = 3
    X = [grid[..., i].long() for i in range(n)]
    m = 1 << (depth - 1)
    q = m
    while q > 1:
        p = q - 1
        for i in range(n):
            has = (X[i] & q) != 0
            t = (X[0] ^ X[i]) & p
            x0 = torch.where(has, X[0] ^ p, X[0] ^ t)
            if i > 0:
                X[i] = torch.where(has, X[i], X[i] ^ t)
            X[0] = x0
        q >>= 1
    for i in range(1, n):                       # gray encode
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    q = m
    while q > 1:
        t = torch.where((X[n - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    X = [x ^ t for x in X]
    code = torch.zeros_like(X[0])
    for b in range(depth):                      # interleave, MSB first
        for i in range(n):
            code |= ((X[i] >> b) & 1) << (b * n + (n - 1 - i))
    return code


def serialize(grid: torch.Tensor, order: str, depth: int = 10
              ) -> torch.Tensor:
    """Curve code for one of the four orders; '-trans' swaps x and y."""
    g = grid[..., (1, 0, 2)] if order.endswith("-trans") else grid
    if order.startswith("z"):
        return z_order_encode(g, depth)
    return hilbert_encode(g, depth)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: a normal truncated at ±2σ, variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    x = torch.randn(w.shape, generator=gen)
    while True:
        out = x.abs() > 2
        if not out.any():
            break
        x[out] = torch.randn(int(out.sum()), generator=gen)
    with torch.no_grad():
        w.copy_(x * std)


def _dense(n_in: int, n_out: int, gen: torch.Generator) -> nn.Linear:
    lin = nn.Linear(n_in, n_out)
    _lecun_normal_(lin.weight, n_in, gen)
    nn.init.zeros_(lin.bias)
    return lin


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: E[x²] - E[x]² clipped at 0, epsilon 1e-6,
    (x - μ) · (rsqrt(var + ε) · scale) + bias."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        return (x - mu) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias


class _MLP(nn.Module):
    def __init__(self, channels: int, hidden: int, out: int,
                 gen: torch.Generator):
        super().__init__()
        self.fc1 = _dense(channels, hidden, gen)
        self.fc2 = _dense(hidden, out, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DropPath(nn.Module):
    """Stochastic depth on a residual branch: the whole branch is dropped
    for the cloud with probability `rate` in training mode and scaled by
    1/keep otherwise; one draw from `generator` per call."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if deterministic or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand((), generator=generator,
                       device=generator.device).to(x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class PDNorm(nn.Module):
    """Point-decoupled norm: one (scale, bias) pair per dataset condition
    over shared statistics (`decouple`), else a LayerNorm; with `adaptive`
    a SiLU -> Linear context modulation `x · (1 + scale) + shift`."""

    def __init__(self, num_features: int,
                 conditions: Sequence[str] = ("ScanNet", "S3DIS",
                                              "Structured3D"),
                 decouple: bool = True, adaptive: bool = False,
                 context_channels: int = 256, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.conditions = tuple(conditions)
        self.decouple, self.adaptive = decouple, adaptive
        if decouple:
            self.scales = nn.Parameter(torch.ones(len(conditions),
                                                  num_features))
            self.biases = nn.Parameter(torch.zeros(len(conditions),
                                                   num_features))
        else:
            self.norm = LayerNorm(num_features)
        if adaptive:
            self.modulation = _dense(context_channels, 2 * num_features, gen)

    def forward(self, x: torch.Tensor, condition: int = 0,
                context: torch.Tensor | None = None) -> torch.Tensor:
        if self.decouple:
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            x = (x - mu) / torch.sqrt(var + 1e-6)
            x = x * self.scales[condition] + self.biases[condition]
        else:
            x = self.norm(x)
        if self.adaptive:
            if context is None:
                raise ValueError("adaptive PDNorm needs a context")
            scale, shift = self.modulation(F.silu(context)).chunk(2, dim=-1)
            x = x * (1.0 + scale) + shift
        return x


class SerializedAttention(nn.Module):
    """flax MultiHeadDotProductAttention over patches of the curve-sorted
    rows, the mask on the keys only."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 gen: torch.Generator):
        super().__init__()
        self.num_heads, self.patch_size = num_heads, patch_size
        self.head_dim = channels // num_heads
        self.query = _dense(channels, channels, gen)
        self.key = _dense(channels, channels, gen)
        self.value = _dense(channels, channels, gen)
        self.out = _dense(channels, channels, gen)

    def forward(self, x, sort_idx, inv_idx, mask) -> torch.Tensor:
        n, c = x.shape
        k = self.patch_size
        pad = (-n) % k
        xs = F.pad(x[sort_idx], (0, 0, 0, pad))
        ms = F.pad(mask[sort_idx], (0, pad))
        g = xs.shape[0] // k
        xs = xs.reshape(g, k, c)
        keys = (ms.reshape(g, 1, 1, k) > 0)
        heads = (self.num_heads, self.head_dim)
        q = self.query(xs).unflatten(-1, heads) / math.sqrt(self.head_dim)
        key = self.key(xs).unflatten(-1, heads)
        w = torch.einsum("gqhd,gkhd->ghqk", q, key)
        w = torch.where(keys, w, torch.finfo(w.dtype).min).softmax(dim=-1)
        out = torch.einsum("ghqk,gkhd->gqhd", w,
                           self.value(xs).unflatten(-1, heads))
        out = self.out(out.flatten(-2)).reshape(g * k, c)[:n]
        return out[inv_idx] * mask[:, None]


class Block(nn.Module):
    """xCPE (a depthwise conv of width 3 along the serialized order, edge
    rows replicated over the whole buffer) + attention + MLP with pre-norm
    residuals, each branch under the block's DropPath."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.cpe_w = nn.Parameter(torch.randn(3, channels, generator=gen)
                                  * 0.02)
        self.norm1 = LayerNorm(channels)
        self.attn = SerializedAttention(channels, num_heads, patch_size, gen)
        self.norm2 = LayerNorm(channels)
        self.mlp = _MLP(channels, int(channels * mlp_ratio), channels, gen)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, sort_idx, inv_idx, mask, *,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        xs = x[sort_idx]
        w = self.cpe_w
        left = torch.cat([xs[:1], xs[:-1]])
        right = torch.cat([xs[1:], xs[-1:]])
        cpe = left * w[0] + xs * w[1] + right * w[2]
        x = x + cpe[inv_idx] * mask[:, None]
        h = self.attn(self.norm1(x), sort_idx, inv_idx, mask)
        x = x + self.drop_path(h, deterministic, generator)
        h = self.mlp(self.norm2(x))
        return x + self.drop_path(h * mask[:, None], deterministic, generator)


def _sort_and_inverse(code: torch.Tensor, mask: torch.Tensor):
    """Alive rows by code (ties in index order), dead rows last; and the
    inverse permutation."""
    key = torch.where(mask > 0, code, torch.full_like(code, _BIG))
    sort_idx = torch.argsort(key, stable=True)
    inv_idx = torch.empty_like(sort_idx)
    inv_idx[sort_idx] = torch.arange(len(sort_idx), device=code.device)
    return sort_idx, inv_idx


def grid_pool(feats, grid, code_fn, mask, pool_bits: int = 1):
    """Merge points sharing a coarse grid cell, keeping capacity N.
    -> (mean-pooled features, the cells' mean grid >> pool_bits, each
    original row's parent, the new alive mask)."""
    n = feats.shape[0]
    code = code_fn(grid >> pool_bits)
    key = torch.where(mask > 0, code, torch.full_like(code, _BIG))
    sorted_key, order = torch.sort(key, stable=True)
    alive = sorted_key != _BIG
    head = torch.ones_like(sorted_key)
    head[1:] = (sorted_key[1:] != sorted_key[:-1]).long()
    head = head * alive.long()
    seg_of_sorted = torch.cumsum(head, 0) - 1
    num_seg = (seg_of_sorted[-1] + 1).clamp_min(0)
    seg = torch.where(alive, seg_of_sorted, torch.full_like(seg_of_sorted,
                                                            n - 1))
    ones = alive.to(torch.float32)
    cnt = torch.zeros(n, dtype=torch.float32, device=feats.device) \
        .index_add(0, seg, ones)
    fsum = torch.zeros_like(feats).index_add(0, seg,
                                             feats[order] * ones[:, None])
    gsum = torch.zeros(n, 3, dtype=torch.float32, device=feats.device) \
        .index_add(0, seg, grid[order].to(torch.float32) * ones[:, None])
    denom = cnt.clamp_min(1.0)[:, None]
    pooled = fsum / denom
    pooled_grid = (gsum / denom).to(torch.int32) >> pool_bits
    new_mask = (torch.arange(n, device=feats.device) < num_seg) \
        .to(mask.dtype)
    parent = torch.empty_like(seg)
    parent[order] = seg
    return pooled, pooled_grid, parent, new_mask


class PointTransformerV3(nn.Module):
    """Encoder-decoder PTv3 over one padded point cloud:
    forward(feats (N, C_in), grid (N, 3) int, mask (N,)) -> (N,
    dec_channels[0]), dead rows zero. Weights are flax's initialisers drawn
    from `torch.Generator(seed)`; `ptv3_from_flax` loads a flax tree. The
    model lives on the card unless `device="cpu"` asks for the CPU (it
    raises without a card)."""

    def __init__(self, in_channels: int = 6,
                 enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
                 enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
                 enc_heads: Sequence[int] = (2, 4, 8, 16, 32),
                 dec_depths: Sequence[int] = (2, 2, 2, 2),
                 dec_channels: Sequence[int] = (64, 64, 128, 256),
                 dec_heads: Sequence[int] = (4, 4, 8, 16),
                 patch_size: int = 48,
                 orders: Sequence[str] = _ORDERS,
                 curve_depth: int = 10,
                 drop_path: float = 0.3,
                 shuffle_orders: bool = True,
                 pdnorm_ln: bool = False,
                 pdnorm_conditions: Sequence[str] = ("ScanNet", "S3DIS",
                                                     "Structured3D"),
                 *, seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        n_stages = len(enc_depths)
        if len(dec_depths) != n_stages - 1:
            raise ValueError("dec_depths needs one stage fewer than "
                             "enc_depths")
        self.orders, self.curve_depth = tuple(orders), curve_depth
        self.shuffle_orders, self.patch_size = shuffle_orders, patch_size

        def norm(c):
            return PDNorm(c, conditions=pdnorm_conditions) if pdnorm_ln \
                else LayerNorm(c)

        def blocks(depth, channels, heads, rates):
            return nn.ModuleList(
                Block(channels, heads, patch_size, drop_path=r,
                      generator=gen) for r in rates[:depth])

        enc_dp, dec_dp = (_rates(drop_path, enc_depths),
                          _rates(drop_path, dec_depths))
        self.embed = _dense(in_channels, enc_channels[0], gen)
        self.embed_norm = norm(enc_channels[0])
        self.enc_proj = nn.ModuleList()
        self.enc_norm = nn.ModuleList()
        self.enc_blocks = nn.ModuleList()
        for s in range(n_stages):
            if s > 0:
                self.enc_proj.append(_dense(enc_channels[s - 1],
                                            enc_channels[s], gen))
                self.enc_norm.append(norm(enc_channels[s]))
            self.enc_blocks.append(blocks(enc_depths[s], enc_channels[s],
                                          enc_heads[s], enc_dp[s]))
        # decoder stages run from the deepest skip (s = n_stages - 2) up
        self.dec_proj = nn.ModuleList()
        self.dec_norm = nn.ModuleList()
        self.dec_blocks = nn.ModuleList()
        above = enc_channels[-1]
        for s in range(n_stages - 2, -1, -1):
            self.dec_proj.append(_dense(above + enc_channels[s],
                                        dec_channels[s], gen))
            self.dec_norm.append(norm(dec_channels[s]))
            self.dec_blocks.append(blocks(dec_depths[s], dec_channels[s],
                                          dec_heads[s], dec_dp[s]))
            above = dec_channels[s]
        self.to(resolve_device(device))

    def _norm(self, module, x, m, condition):
        x = module(x, condition) if isinstance(module, PDNorm) else module(x)
        return x * m[:, None]

    def _run_blocks(self, blocks, x, g, m, deterministic, generator):
        n_ord = len(self.orders)
        if self.shuffle_orders and not deterministic:
            perm = torch.randperm(n_ord, generator=generator,
                                  device=generator.device).tolist()
        else:
            perm = list(range(n_ord))
        codes = {}
        for b, block in enumerate(blocks):
            o = perm[b % n_ord]
            if o not in codes:
                codes[o] = _sort_and_inverse(
                    serialize(g, self.orders[o], self.curve_depth), m)
            si, ii = codes[o]
            x = block(x, si, ii, m, deterministic=deterministic,
                      generator=generator)
        return x

    def forward(self, feats: torch.Tensor, grid: torch.Tensor,
                mask: torch.Tensor, *, deterministic: bool = True,
                condition: int = 0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not deterministic and generator is None:
            raise ValueError("training mode (deterministic=False) needs a "
                             "torch.Generator")
        mask = mask.to(torch.float32)
        x = self._norm(self.embed_norm, self.embed(feats), mask, condition)
        x = F.gelu(x, approximate="tanh") * mask[:, None]
        enc_x, enc_g, enc_m, parents = [], [], [], []
        g, m = grid, mask
        for s, blocks in enumerate(self.enc_blocks):
            if s > 0:
                pooled, g, parent, m = grid_pool(
                    x, g, lambda c: z_order_encode(c, self.curve_depth), m)
                x = self._norm(self.enc_norm[s - 1],
                               self.enc_proj[s - 1](pooled), m, condition)
                parents.append(parent)
            x = self._run_blocks(blocks, x, g, m, deterministic, generator)
            enc_x.append(x)
            enc_g.append(g)
            enc_m.append(m)
        n_stages = len(self.enc_blocks)
        for i, s in enumerate(range(n_stages - 2, -1, -1)):
            x = torch.cat([x[parents[s]], enc_x[s]], dim=-1)
            x = self._norm(self.dec_norm[i], self.dec_proj[i](x), enc_m[s],
                           condition)
            x = self._run_blocks(self.dec_blocks[i], x, enc_g[s], enc_m[s],
                                 deterministic, generator)
        return x * enc_m[0][:, None]


def _rates(drop_path: float, depths: Sequence[int]) -> list[list[float]]:
    """Per-block stochastic-depth rates: a linspace over all blocks of the
    trunk, cut by stage."""
    tot = sum(depths)
    flat = [drop_path * i / max(tot - 1, 1) for i in range(tot)]
    out, ofs = [], 0
    for d in depths:
        out.append(flat[ofs:ofs + d])
        ofs += d
    return out


# ---------------------------------------------------------------------------
# the flax weight carrier
# ---------------------------------------------------------------------------

class _Leaves:
    """A flax tree's leaves by path; each may be taken once."""

    def __init__(self, tree: dict):
        self.left: dict[str, np.ndarray] = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict) or hasattr(v, "items"):
                    walk(v, f"{prefix}{k}/")
                else:
                    self.left[f"{prefix}{k}"] = np.asarray(v, np.float32)
        walk(tree, "")

    def take(self, path: str) -> np.ndarray:
        if path not in self.left:
            raise ValueError(f"ptv3_from_flax: no leaf {path!r} (or taken "
                             "twice)")
        return self.left.pop(path)


def _join(path: str, name: str) -> str:
    return f"{path}/{name}" if path else name


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _load_dense(lin: nn.Linear, leaves: _Leaves, path: str):
    kernel = leaves.take(_join(path, "kernel"))
    lin.weight.data = _t(kernel.reshape(kernel.shape[0], -1).T)
    lin.bias.data = _t(leaves.take(_join(path, "bias")).reshape(-1))


def _load_norm(mod, leaves: _Leaves, path: str):
    if isinstance(mod, LayerNorm):
        mod.weight.data = _t(leaves.take(_join(path, "scale")))
        mod.bias.data = _t(leaves.take(_join(path, "bias")))
        return
    if mod.decouple:
        for name, param in (("scale", mod.scales), ("bias", mod.biases)):
            param.data = _t(np.stack([
                leaves.take(_join(path, f"norm_{c}_{name}"))
                for c in mod.conditions]))
    else:
        _load_norm(mod.norm, leaves, _join(path, "LayerNorm_0"))
    if mod.adaptive:
        _load_dense(mod.modulation, leaves, _join(path, "Dense_0"))


def _load_attention(attn: SerializedAttention, leaves: _Leaves, path: str):
    mha = _join(path, "MultiHeadDotProductAttention_0")
    for name in ("query", "key", "value"):     # kernel (C, H, D)
        _load_dense(getattr(attn, name), leaves, _join(mha, name))
    kernel = leaves.take(_join(mha, "out/kernel"))  # (H, D, C)
    attn.out.weight.data = _t(kernel.reshape(-1, kernel.shape[-1]).T)
    attn.out.bias.data = _t(leaves.take(_join(mha, "out/bias")))


def _load_block(block: Block, leaves: _Leaves, path: str):
    block.cpe_w.data = _t(leaves.take(_join(path, "cpe_w")))
    _load_norm(block.norm1, leaves, _join(path, "LayerNorm_0"))
    _load_attention(block.attn, leaves, _join(path, "SerializedAttention_0"))
    _load_norm(block.norm2, leaves, _join(path, "LayerNorm_1"))
    _load_dense(block.mlp.fc1, leaves, _join(path, "_MLP_0/Dense_0"))
    _load_dense(block.mlp.fc2, leaves, _join(path, "_MLP_0/Dense_1"))


def ptv3_from_flax(params: dict, *, device: str | torch.device = "cuda",
                   **config) -> PointTransformerV3:
    """The port's model, built with `config` (the flax model's constructor
    arguments), holding the weights of a flax PointTransformerV3 tree (with
    or without the top-level 'params'). flax names submodules by creation
    order: Dense_i / LayerNorm_i (PDNorm_i with `pdnorm_ln`) for the
    embedding, each encoder stage after the first and each decoder stage,
    Block_j for the blocks, encoder first. Every leaf is consumed once;
    anything missing or left over raises ValueError. The model goes to
    `device` (the card unless "cpu" is asked for)."""
    model = PointTransformerV3(**config, device="cpu")
    leaves = _Leaves(params.get("params", params))
    norm_name = "PDNorm" if config.get("pdnorm_ln") else "LayerNorm"
    dense_i, block_j = itertools.count(), itertools.count()

    def stage(proj, norm, blocks):
        i = next(dense_i)
        _load_dense(proj, leaves, f"Dense_{i}")
        _load_norm(norm, leaves, f"{norm_name}_{i}")
        for blk in blocks:
            _load_block(blk, leaves, f"Block_{next(block_j)}")

    stage(model.embed, model.embed_norm, [])
    for s, blocks in enumerate(model.enc_blocks):
        if s == 0:
            for blk in blocks:
                _load_block(blk, leaves, f"Block_{next(block_j)}")
        else:
            stage(model.enc_proj[s - 1], model.enc_norm[s - 1], blocks)
    for i, blocks in enumerate(model.dec_blocks):
        stage(model.dec_proj[i], model.dec_norm[i], blocks)
    if leaves.left:
        raise ValueError(f"ptv3_from_flax: unused leaves "
                         f"{sorted(leaves.left)[:8]}")
    return model.to(resolve_device(device))
