"""The reference's training steps: the trainers' deform-phase iteration in
plain PyTorch, from the same starting point as the program.

One step over a batch of views (sorted by time): the deformation (the
MLP per view; the ODE once, as one trajectory through the batch's times
from the canonical means), SH and projection, the compositing, the
photometric loss averaged over the views, the gradients by autograd, then
Adam on the six Gaussian parameters (rows that are not alive get no
gradient) and on the field's weights. The compositing's gradient is taken
one block of tiles at a time, and the ODE's one block of rows at a time,
each recomputed (`render.image_vjp`; the rows of the ODE are independent).

`run` returns each step's loss, each leaf's gradient norm at the first
step (as the optimizer takes it) and each leaf's change over all steps.
"""
from __future__ import annotations

import torch

from . import fields, losses, optim, render

GAUSSIAN_LEAVES = ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity")
ODE_BLOCK_BYTES = 16e9        # activations of one block of ODE rows
ODE_ROW_EVAL_BYTES = 32e3     # per row and evaluation of the dynamics


def field_leaves(weights) -> list[str]:
    return [f"field.{i}.{part}" for i in range(len(weights))
            for part in ("weight", "bias")]


def _flat(weights):
    return [t for pair in weights for t in pair]


def _pairs(flat):
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def ode_rows_per_block(evals: int) -> int:
    return max(256, int(ODE_BLOCK_BYTES / (max(evals, 1)
                                           * ODE_ROW_EVAL_BYTES)))


def _view_grads(P, alive, means, d_rot, d_scale, view, target, bg, lam,
                weight):
    """Loss of one view (times `weight`) and the backward of its image
    into whatever `means` and P hang on."""
    sp = render.splats_for(P, alive, means, d_rot, d_scale, view)
    img, _ = render.image(sp, view.width, view.height, bg)
    img = img.requires_grad_()
    with torch.enable_grad():
        loss = losses.photometric(img, target, lam) * weight
        (g_img,) = torch.autograd.grad(loss, img)
    g_rec = render.image_vjp(sp, view.width, view.height, bg, g_img)
    torch.autograd.backward(sp.records, g_rec)
    return float(loss.detach())


def step_grads(params: dict, alive, weights, field: dict, views, targets,
               bg, lam: float):
    """-> (loss, {leaf: gradient}) of one step over `views` (sorted by
    time), the loss their mean."""
    P = {k: v.detach().requires_grad_() for k, v in params.items()}
    flat = [t.detach().requires_grad_() for t in _flat(weights)]
    Wt = _pairs(flat)
    k = len(views)
    loss = 0.0
    with torch.enable_grad():
        if field["kind"] == "ode":
            f = fields.dynamics(Wt, field)
            times = [v.fid for v in views]
            subs = field["n_substeps"]
            with torch.no_grad():
                ys = fields.trajectory(f, P["xyz"].detach(), times, subs)
            Y = ys.requires_grad_()
            for i, (view, target) in enumerate(zip(views, targets)):
                loss += _view_grads(P, alive, Y[i], 0.0, 0.0, view, target,
                                    bg, lam, 1.0 / k)
            rows = ode_rows_per_block(4 * subs * max(len(times) - 1, 1))
            xyz = P["xyz"].detach()
            for r0 in range(0, xyz.shape[0], rows):
                yb = fields.trajectory(f, xyz[r0:r0 + rows], times, subs)
                torch.autograd.backward(yb, Y.grad[:, r0:r0 + rows])
        else:
            for view, target in zip(views, targets):
                dx, dr, ds = fields.mlp(Wt, field, P["xyz"].detach(),
                                        view.fid)
                loss += _view_grads(P, alive, P["xyz"] + dx, dr, ds, view,
                                    target, bg, lam, 1.0 / k)
    grads = {}
    for name in GAUSSIAN_LEAVES:
        g = P[name].grad
        g = torch.zeros_like(P[name]) if g is None else g
        grads[name] = g * alive.reshape((-1,) + (1,) * (g.ndim - 1))
    for name, t in zip(field_leaves(weights), flat):
        grads[name] = torch.zeros_like(t) if t.grad is None else t.grad
    return loss, grads


@torch.no_grad()
def run(params: dict, alive, weights, field: dict, opt: dict, batches,
        targets_of, bg, iteration0: int, spatial_lr_scale: float) -> dict:
    """`len(batches)` steps from (params, weights) with zero moments.
    `batches`: per step the list of views (sorted by time); `targets_of`:
    view -> its target image. -> {"losses", "grad_norms", "change_norms"}
    (norms per leaf: the first step's gradient, the change over all)."""
    g_params = [params[k] for k in GAUSSIAN_LEAVES]
    f_params = _flat(weights)
    g_adam, f_adam = optim.Adam(g_params), optim.Adam(f_params)
    lam = opt["lambda_dssim"]
    wd = opt.get("weight_decay", 0.0)
    out = {"losses": [], "grad_norms": {}, "change_norms": {}}
    for s, views in enumerate(batches):
        it = iteration0 + s
        cur = dict(zip(GAUSSIAN_LEAVES, g_params))
        loss, grads = step_grads(cur, alive, _pairs(f_params), field, views,
                                 [targets_of(v) for v in views], bg, lam)
        out["losses"].append(loss)
        fg = [grads[n] + wd * p
              for n, p in zip(field_leaves(weights), f_params)]
        if s == 0:
            for n in GAUSSIAN_LEAVES:
                out["grad_norms"][n] = float(torch.linalg.vector_norm(
                    grads[n]))
            for n, g in zip(field_leaves(weights), fg):
                out["grad_norms"][n] = float(torch.linalg.vector_norm(g))
        lrs = optim.gaussian_lrs(opt, it, spatial_lr_scale)
        g_params = g_adam.step(g_params, [grads[n] for n in GAUSSIAN_LEAVES],
                               [lrs[n] for n in GAUSSIAN_LEAVES])
        dlr = optim.deform_lr(opt, it, opt.get("num_cams_per_iter", 1))
        f_params = f_adam.step(f_params, fg, [dlr] * len(fg))
    for n, p0, p1 in zip(GAUSSIAN_LEAVES, [params[k] for k in GAUSSIAN_LEAVES],
                         g_params):
        out["change_norms"][n] = float(torch.linalg.vector_norm(p1 - p0))
    for n, p0, p1 in zip(field_leaves(weights), _flat(weights), f_params):
        out["change_norms"][n] = float(torch.linalg.vector_norm(p1 - p0))
    return out
