"""Time-series transformer for Gaussian-trajectory forecasting (counterpart
of `d3gs_tpu/forecast/model.py`, the reference's HuggingFace
TimeSeriesTransformerForPrediction experiment, forecast_exp/
forecast_test.py:52-124: d_model 128, 4+4 layers, lags [1..5], past 80 →
future 30 per-Gaussian position windows).

A compact encoder-decoder over per-window z-normalized position sequences:
lag features [1..5] concatenated to the input, sinusoidal time embeddings,
pre-LN blocks, a causal decoder trained with teacher forcing and rolled out
autoregressively (`train.forecast`). The layers compute what flax's do:
LayerNorm with epsilon 1e-6, the tanh GELU, attention that divides the
query by √head_dim and masks with the dtype's most negative value.
`forecaster_from_flax` carries a flax parameter tree across.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LAGS = (1, 2, 3, 4, 5)
LN_EPS = 1e-6                    # flax nn.LayerNorm's epsilon


def sinusoidal_embedding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., L) positions -> (..., L, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    args = positions[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at ±2σ, scaled to
    variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    x = torch.randn(w.shape, generator=generator)
    while True:
        out = x.abs() > 2
        if not out.any():
            break
        x[out] = torch.randn(int(out.sum()), generator=generator)
    with torch.no_grad():
        w.copy_(x * std)


def _dense(n_in: int, n_out: int, gen: torch.Generator) -> nn.Linear:
    lin = nn.Linear(n_in, n_out)
    _lecun_normal_(lin.weight, n_in, gen)
    nn.init.zeros_(lin.bias)
    return lin


class Attention(nn.Module):
    """flax MultiHeadDotProductAttention (qkv_features = d_model, no
    dropout): query/key/value projections to (heads, head_dim), the scaled
    dot product, softmax over the keys, the output projection."""

    def __init__(self, d_model: int, n_heads: int, gen: torch.Generator):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, d_model // n_heads
        self.query = _dense(d_model, d_model, gen)
        self.key = _dense(d_model, d_model, gen)
        self.value = _dense(d_model, d_model, gen)
        self.out = _dense(d_model, d_model, gen)

    def forward(self, x: torch.Tensor, kv: torch.Tensor | None = None,
                causal: bool = False) -> torch.Tensor:
        kv = x if kv is None else kv
        lq = x.shape[1]
        split = lambda t: t.unflatten(-1, (self.n_heads, self.head_dim))  # noqa: E731
        q = split(self.query(x)) / math.sqrt(self.head_dim)
        k, v = split(self.key(kv)), split(self.value(kv))
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if causal:
            keep = torch.ones(lq, kv.shape[1], dtype=torch.bool,
                              device=x.device).tril()
            w = w.masked_fill(~keep, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).flatten(-2))


class Block(nn.Module):
    """Pre-LN transformer block: (causal) self-attention, cross-attention
    to a LayerNorm'd context where one is given (the decoder), then a 4×
    tanh-GELU MLP, each with a residual."""

    def __init__(self, d_model: int, n_heads: int, causal: bool = False,
                 cross: bool = False, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.causal = causal
        self.norm_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = Attention(d_model, n_heads, g)
        if cross:
            self.norm_cross = nn.LayerNorm(d_model, eps=LN_EPS)
            self.cross = Attention(d_model, n_heads, g)
            self.norm_context = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_mlp = nn.LayerNorm(d_model, eps=LN_EPS)
        self.fc1 = _dense(d_model, 4 * d_model, g)
        self.fc2 = _dense(4 * d_model, d_model, g)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.norm_attn(x), causal=self.causal)
        if context is not None:
            x = x + self.cross(self.norm_cross(x), self.norm_context(context))
        h = F.gelu(self.fc1(self.norm_mlp(x)), approximate="tanh")
        return x + self.fc2(h)


def _lag_features(seq: torch.Tensor) -> torch.Tensor:
    """(B, L, D) -> (B, L, D·(1+len(LAGS))): the sequence and its lagged
    copies, zero-padded at the left edge."""
    feats = [seq]
    for lag in LAGS:
        feats.append(F.pad(seq, (0, 0, lag, 0))[:, :seq.shape[1]])
    return torch.cat(feats, dim=-1)


class TrajectoryForecaster(nn.Module):
    def __init__(self, d_model: int = 128, n_heads: int = 4,
                 enc_layers: int = 4, dec_layers: int = 4, dim: int = 3,
                 *, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.d_model, self.dim = d_model, dim
        self.enc_in = _dense(dim * (1 + len(LAGS)), d_model, g)
        self.enc_blocks = nn.ModuleList(
            Block(d_model, n_heads, generator=g) for _ in range(enc_layers))
        self.enc_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dec_in = _dense(dim, d_model, g)
        self.dec_blocks = nn.ModuleList(
            Block(d_model, n_heads, causal=True, cross=True, generator=g)
            for _ in range(dec_layers))
        self.dec_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.head = _dense(d_model, dim, g)

    def forward(self, past: torch.Tensor,
                future_in: torch.Tensor) -> torch.Tensor:
        """past (B, Lp, D); future_in (B, Lf, D) decoder inputs (the last
        past point, then the shifted future under teacher forcing). ->
        (B, Lf, D) predicted positions in normalized space."""
        lp, lf = past.shape[1], future_in.shape[1]
        pos = torch.arange(lp + lf, dtype=torch.float32, device=past.device)
        emb = sinusoidal_embedding(pos, self.d_model)
        enc = self.enc_in(_lag_features(past)) + emb[None, :lp]
        for blk in self.enc_blocks:
            enc = blk(enc)
        enc = self.enc_norm(enc)
        dec = self.dec_in(future_in) + emb[None, lp:]
        for blk in self.dec_blocks:
            dec = blk(dec, context=enc)
        return self.head(self.dec_norm(dec))


def normalize_window(past: torch.Tensor):
    """Instance normalization over the past window (per sample, per dim;
    the population standard deviation, as jnp.std)."""
    mu = past.mean(dim=1, keepdim=True)
    sd = ((past - mu) ** 2).mean(dim=1, keepdim=True).sqrt() + 1e-6
    return (past - mu) / sd, mu, sd


# flax submodule names of each block, in their creation order
_BLOCK_LAYERS = {"attn": "MultiHeadDotProductAttention_0",
                 "cross": "MultiHeadDotProductAttention_1",
                 "fc1": "Dense_0", "fc2": "Dense_1"}
_ENC_NORMS = {"norm_attn": "LayerNorm_0", "norm_mlp": "LayerNorm_1"}
_DEC_NORMS = {"norm_attn": "LayerNorm_0", "norm_cross": "LayerNorm_1",
              "norm_context": "LayerNorm_2", "norm_mlp": "LayerNorm_3"}


def _linear_state(p: dict) -> dict:
    return {"weight": torch.from_numpy(np.ascontiguousarray(
        np.asarray(p["kernel"], np.float32).T)),
        "bias": torch.from_numpy(np.array(p["bias"], np.float32))}


def _attention_state(p: dict) -> dict:
    out = {}
    for name in ("query", "key", "value"):        # kernel (in, heads, hd)
        k = np.asarray(p[name]["kernel"], np.float32)
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            k.reshape(k.shape[0], -1).T))
        out[f"{name}.bias"] = torch.from_numpy(
            np.array(p[name]["bias"], np.float32).reshape(-1))
    k = np.asarray(p["out"]["kernel"], np.float32)   # (heads, hd, out)
    out["out.weight"] = torch.from_numpy(np.ascontiguousarray(
        k.reshape(-1, k.shape[-1]).T))
    out["out.bias"] = torch.from_numpy(np.array(p["out"]["bias"],
                                                  np.float32))
    return out


def _norm_state(p: dict) -> dict:
    return {"weight": torch.from_numpy(np.array(p["scale"], np.float32)),
            "bias": torch.from_numpy(np.array(p["bias"], np.float32))}


def forecaster_from_flax(params: dict) -> TrajectoryForecaster:
    """The port's module holding the weights of a flax TrajectoryForecaster
    parameter tree (nested dicts of arrays, with or without the top-level
    'params'). Widths and layer counts are read from the tree; blocks are
    matched by name (Block_0 .. Block_{enc+dec-1}, the decoder's carrying
    MultiHeadDotProductAttention_1)."""
    p = params.get("params", params)
    blocks = sorted((k for k in p if k.startswith("Block_")),
                    key=lambda k: int(k.split("_")[1]))
    dec = [k for k in blocks if "MultiHeadDotProductAttention_1" in p[k]]
    enc = [k for k in blocks if k not in dec]
    if blocks != enc + dec:
        raise ValueError(f"decoder blocks must follow the encoder's: {blocks}")
    q = np.asarray(p[blocks[0]]["MultiHeadDotProductAttention_0"]["query"]
                   ["kernel"])
    d_model, n_heads = q.shape[0], q.shape[1]
    dim = np.asarray(p["Dense_2"]["kernel"]).shape[1]
    model = TrajectoryForecaster(d_model=d_model, n_heads=n_heads,
                                 enc_layers=len(enc), dec_layers=len(dec),
                                 dim=dim)
    state = {}

    def put(prefix, sub):
        state.update({f"{prefix}.{k}": v for k, v in sub.items()})

    put("enc_in", _linear_state(p["Dense_0"]))
    put("dec_in", _linear_state(p["Dense_1"]))
    put("head", _linear_state(p["Dense_2"]))
    put("enc_norm", _norm_state(p["LayerNorm_0"]))
    put("dec_norm", _norm_state(p["LayerNorm_1"]))
    for group, names, norms in (("enc_blocks", enc, _ENC_NORMS),
                                ("dec_blocks", dec, _DEC_NORMS)):
        for i, name in enumerate(names):
            bp, pre = p[name], f"{group}.{i}"
            for attr, flax_name in _BLOCK_LAYERS.items():
                if flax_name not in bp:
                    continue
                sub = (_attention_state if attr in ("attn", "cross")
                       else _linear_state)(bp[flax_name])
                put(f"{pre}.{attr}", sub)
            for attr, flax_name in norms.items():
                put(f"{pre}.{attr}", _norm_state(bp[flax_name]))
    model.load_state_dict(state)
    return model
