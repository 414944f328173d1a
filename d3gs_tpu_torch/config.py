"""Configuration: dataclass parameter groups + CLI reflection.

Copy of `d3gs_tpu/config.py` (the port imports nothing of the JAX package).
Field names and the JSON `cfg_args` format are the same, so a model
directory written by the JAX trainer loads here. Every field auto-registers
an argparse flag (bools become store_true), `_shorthand` fields get
single-letter aliases, and `get_combined_args` merges a run's saved cfg_args
with the CLI.

The TPU-only pipeline knobs (tile capacities and chunks, dispatch batching,
matmul precision, mesh layout) still parse, so existing flags and run
configs load, but the port reads none of them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from dataclasses import dataclass


@dataclass
class ModelParams:
    """Data + deformation-net hyperparameters (reference ModelParams:50-79)."""
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    is_blender: bool = True
    is_6dof: bool = False
    is_ode: bool = False
    use_torch_ode: bool = False
    sh_degree: int = 3
    max_gaussians: int = 500_000
    # deformation MLP hyperparams
    D: int = 8
    W: int = 256
    input_ch: int = 3
    output_ch: int = 59
    multires: int = 10
    use_linear: int = 0
    use_emb: bool = True
    output_scale: float = 1.0
    ode_solver: str = "rk4"
    deform_dtype: str = "float32"
    load2gpu_on_the_fly: bool = False
    data_device: str = "tpu"

    _shorthand = {"source_path": "s", "model_path": "m", "images": "i",
                  "resolution": "r", "white_background": "w"}


@dataclass
class PipelineParams:
    """Render-path toggles (reference PipelineParams:82-87).

    `binning` and `tight_cull` select among the JAX package's blend paths;
    the port has one (record binning + the tile-blend kernel), so anything
    but the defaults raises."""
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    # --- TPU-only knobs: parsed, not read ---
    tile_capacity: int = 1024
    tile_chunk: int = 40
    bin_chunk: int = 2048
    binning: str = "auto"
    dup_capacity: int = 0           # duplicate budget (0 = 16N)
    tight_cull: bool = False
    capacity: int = 0               # padded gaussian buffer (0 = auto)
    antialias: bool = False         # filter-norm style opacity compensation
    mesh_shape: str = ""
    mesh_mode: str = "camera"
    depth_grad: bool = False
    train_matmul_precision: str = "bfloat16"
    steps_per_dispatch: int = 1

    def __post_init__(self):
        if self.binning != "auto":
            raise ValueError(
                f"binning={self.binning!r}: the torch port has one blend path "
                "(record binning + the CUDA tile blend); use 'auto'")
        if self.tight_cull:
            raise NotImplementedError(
                "tight_cull is not ported (ROADMAP.md, Queue 1)")


@dataclass
class OptimizationParams:
    """Optimizer/densify/ODE schedule (reference OptimizationParams:90-125)."""
    iterations: int = 40_000
    warm_up: int = 3000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    deform_lr_max_steps: int = 40_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0007
    # batched / ODE trainer knobs
    scale_lr: bool = False
    direct_compute: bool = True
    sequence_length: int = 30
    num_cams_per_iter: int = 10
    spread_out_sequence: bool = False
    weight_decay: float = 0.0
    freeze_gaussians: bool = False
    rtol: float = 1e-3
    atol: float = 1e-4
    use_iterative_update: bool = False
    iterative_update_decay: float = 0.9
    iterative_update_interval: int = 1000
    max_training_switches: int = 5
    max_batch_gaussians: int = -1


def add_group_args(parser: argparse.ArgumentParser, cls, *, fill_none=False):
    """Register one flag per dataclass field (reference ParamGroup:21-47)."""
    short = getattr(cls, "_shorthand", {})
    for f in dataclasses.fields(cls):
        names = [f"--{f.name}"]
        if f.name in short:
            names.append(f"-{short[f.name]}")
        default = None if fill_none else f.default
        if f.type in ("bool", bool):
            parser.add_argument(*names, action="store_true",
                                default=default)
        else:
            ty = {"int": int, "float": float, "str": str}.get(
                f.type if isinstance(f.type, str) else f.type.__name__, str)
            parser.add_argument(*names, type=ty, default=default)


def extract_group(args: argparse.Namespace, cls):
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = getattr(args, f.name, None)
        if v is not None:
            kwargs[f.name] = v
    out = cls(**kwargs)
    if isinstance(out, ModelParams) and out.source_path:
        out.source_path = os.path.abspath(out.source_path)
    return out


def save_cfg_args(model_path: str, model: ModelParams):
    """Persist run config for render-time merging (train.py:343-344)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        json.dump(dataclasses.asdict(model), f, indent=1)


def load_cfg_args(model_path: str) -> dict:
    p = os.path.join(model_path, "cfg_args")
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def get_combined_args(parser: argparse.ArgumentParser, argv=None):
    """CLI over saved cfg_args (reference arguments/__init__.py:128-148)."""
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    saved = load_cfg_args(getattr(args, "model_path", "") or "")
    for k, v in saved.items():
        if getattr(args, k, None) in (None, "", False):
            setattr(args, k, v)
    return args
