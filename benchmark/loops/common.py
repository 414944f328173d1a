"""What the loops share: the scene and weights of a configuration from
the seed, the reference's view of them, and the comparison of norms."""
from __future__ import annotations

import statistics

import torch

from .. import scene
from ..reference import fields


def build(cfg: dict, seed: int, device):
    """-> (generator, teacher params, alive, field weights): the scene and
    the field's weights, drawn from the seed on the device."""
    gen = scene.generator(seed, device)
    n = cfg["gaussians"]
    params, alive = scene.gaussians(n, scene.capacity_for(n),
                                    cfg["sh_degree"], gen, device)
    fref = cfg["field"]
    heads = 3 if fref["kind"] == "baseline" else 1
    weights = scene.linear_weights(fields.layer_shapes(fref), gen, device,
                                   last=heads,
                                   last_scale=fref.get("head_init", 1.0))
    return gen, params, alive, weights


def check_field(field, ref: dict) -> None:
    """Raise unless the program's field is the configuration's."""
    spec = field.spec
    skip = spec.D // 2 if spec.kind == "baseline" else (
        spec.skips[0] if len(spec.skips) == 1 else None)
    want = {"kind": spec.kind, "D": spec.D, "W": spec.W,
            "multires": spec.multires, "is_blender": spec.is_blender,
            "skip": skip}
    if spec.kind == "ode":
        want.update(n_substeps=spec.n_substeps,
                    output_scale=spec.output_scale)
        if (spec.solver, spec.use_linear, spec.use_emb) != ("rk4", 0, True):
            raise ValueError(f"the program's ODE field is {spec}, not the "
                             "configuration's RK4 MLP dynamics")
    if spec.compute_dtype != "float32" or spec.is_6dof:
        raise ValueError(f"the program's field is {spec}")
    got = {k: ref.get(k) for k in want}
    if got != want:
        raise ValueError(f"the program's field {want} is not the "
                         f"configuration's {got}")


def norm_gap(prog: dict, ref: dict, ref_grads: dict) -> tuple[float, str]:
    """The worst leaf's |norm_program - norm_reference|, over the larger
    of that leaf's reference norm and the median leaf's; leaves whose
    reference gradient is under a thousandth of the median leaf's (nought
    to rounding, moved by Adam's round-off alone) are left out. -> (gap,
    leaf)."""
    med_g = statistics.median(ref_grads.values())
    leaves = [k for k in ref if ref_grads[k] >= 1e-3 * med_g]
    med = statistics.median(ref[k] for k in leaves)
    worst, at = 0.0, ""
    for k in leaves:
        den = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / den if den > 0 else 0.0
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def tensor_norms(names, tensors) -> dict:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in zip(names, tensors)}
