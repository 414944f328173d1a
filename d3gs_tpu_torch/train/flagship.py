"""Flagship batched multi-camera / neural-ODE trainer (counterpart of
`d3gs_tpu/train/flagship.py`, the reference train.py::training() :35-330).

Per iteration it picks k = num_cams_per_iter cameras from a time-sorted
(optionally uniformly subsampled, `spread_out_sequence`) window stack with
`random.Random(seed)`, exactly as the JAX trainer does, sorts them by fid,
renders each, and takes one backward through the weighted mean of the
per-camera (1−λ)·L1 + λ·(1−SSIM):

  * MLP kinds (baseline, warp) evaluate the deformation per camera inside
    the camera loop; all k render graphs stay alive until the backward;
  * ODE kinds integrate ONE trajectory through the sorted fids, anchored at
    the first with the canonical means (torchode semantics), and render
    each camera at its absolute positions (`direct_compute`);
  * one screen-space tap is shared by the k renders, so the densification
    statistic is the norm of dL/dmean2d summed over the cameras, and the
    radii are their maximum over the cameras;
  * alternating Gaussian / deform updates with a decaying switch interval
    (`IterativeSchedule`), Gaussian freezing from `base_model_path`, and the
    baseline trainer's densify cadence (skipped when the base is frozen).

With a `parallel.mesh.Mesh` (`mesh=`, one process per rank) the step is
the sharded one of `pipe_cfg.mesh_mode` (parallel/sharded.py): `camera`
replicates the state and splits the camera batch, padded to a multiple of
the ranks with repeated cameras weighted 1/copies; `gauss_tile` shards the
state's rows (and on a 2D mesh splits the batch over the camera groups).
Densify and prune run on the whole state on every rank, gathered first
and re-sharded after, with the same generator everywhere, so the pass
equals the single-device one. Rank 0 alone evaluates, saves and logs.

Not ported: `steps_per_dispatch` (several jitted steps per dispatch) has
no counterpart in an eager loop, and `max_batch_gaussians` is accepted and
ignored, as in JAX.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from random import Random
from typing import NamedTuple

import torch

from ..data.cameras import Camera
from ..models import gaussians as G
from ..models.deform.fields import (MLP_KINDS, ODE_KINDS, DeformFieldSpec,
                                    create_deform_field)
from ..models.renderer import render
from ..ops.losses import l1_loss, ssim
from .baseline import (IterTimer, TrainResult, densify_cadence, densify_due,
                       evaluate, log_evaluation, log_scalars, save_checkpoint,
                       subsample_stack)
from .step import StepAux, make_eval_render


def pick_field_spec(model_cfg, opt_cfg) -> DeformFieldSpec:
    """Reference train.py:55-66 model selection."""
    if model_cfg.use_torch_ode:
        kind = "simple_start"
    elif model_cfg.is_ode:
        kind = "ode"
    else:
        kind = "baseline"
    return DeformFieldSpec(
        kind=kind, is_blender=model_cfg.is_blender,
        is_6dof=model_cfg.is_6dof, D=model_cfg.D, W=model_cfg.W,
        multires=model_cfg.multires, use_linear=model_cfg.use_linear,
        use_emb=model_cfg.use_emb, output_scale=model_cfg.output_scale,
        solver=model_cfg.ode_solver, rtol=opt_cfg.rtol, atol=opt_cfg.atol,
        compute_dtype=model_cfg.deform_dtype)


class BatchGrads(NamedTuple):
    loss: torch.Tensor            # weighted mean over the cameras
    l1: torch.Tensor
    params: G.GaussianParams      # d loss / d the six Gaussian parameters
    deform: list                  # d loss / d the deform parameters
    tap: torch.Tensor             # (C, 2) d loss / d mean2d, summed over
    #                               the cameras
    radii: torch.Tensor           # (C,) largest radius over the cameras
    tile_overflow: torch.Tensor   # largest per-tile count over the cameras
    dup_total: torch.Tensor       # surviving tile duplicates, all cameras


def make_batched_loss_and_grads(*, opt_cfg, pipe_cfg, model_cfg, field,
                                use_deform: bool):
    """-> loss_and_grads(state, cams, bg, wts=None, wsum=None) ->
    BatchGrads: the forward over the k cameras (sorted by fid) and the one
    backward of Σ wts·loss / wsum (wsum defaults to Σ wts; the
    camera-parallel step passes the whole batch's)."""
    lam = opt_cfg.lambda_dssim
    kind = field.spec.kind
    direct = opt_cfg.direct_compute and kind in ODE_KINDS and use_deform
    per_camera = use_deform and kind in MLP_KINDS
    deform_params = list(field.net.parameters()) if use_deform else []

    def loss_and_grads(state: G.GaussianState, cams: list[Camera], bg,
                       wts=None, wsum=None) -> BatchGrads:
        w = [1.0] * len(cams) if wts is None else [float(x) for x in wts]
        params = G.GaussianParams(*(p.detach().requires_grad_()
                                    for p in state.params))
        st = dataclasses.replace(state, params=params)
        tap = torch.zeros((state.capacity, 2), device=bg.device,
                          requires_grad=True)
        xyz = params.xyz.detach()
        if use_deform and not per_camera:
            fids = sorted(float(c.fid) for c in cams)
            staged = field.step_multi(xyz, fids, y0=xyz)
        loss = l1_sum = 0.0
        radii = overflow = dups = None
        for i, cam in enumerate(cams):
            if per_camera:
                dx, dr, ds = field.step(xyz, cam.fid)
            elif use_deform:
                dx, dr, ds = (s[i] for s in staged)
            else:
                dx, dr, ds = 0.0, 0.0, 0.0
            # no tight_cull here, as in the JAX trainer's training render
            # (its eval render, `make_eval_render`, takes it); the cull is
            # output-exact, so the results agree either way
            out = render(st, cam, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                         is_6dof=model_cfg.is_6dof, direct_compute=direct,
                         bg=bg, means2d_tap=tap,
                         dup_capacity=pipe_cfg.dup_capacity,
                         antialias=pipe_cfg.antialias,
                         depth_grad=pipe_cfg.depth_grad)
            ll1 = l1_loss(out.image, cam.image)
            li = (1.0 - lam) * ll1 + lam * (1.0 - ssim(out.image, cam.image))
            loss = loss + w[i] * li
            l1_sum = l1_sum + w[i] * ll1.detach()
            top, total = out.counts.max(), out.counts.sum()
            if radii is None:
                radii, overflow, dups = out.radii, top, total
            else:
                radii = torch.maximum(radii, out.radii)
                overflow, dups = torch.maximum(overflow, top), dups + total
        if wsum is None:
            wsum = sum(w)
        loss = loss / wsum
        inputs = [*params, *deform_params, tap]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True,
                                    materialize_grads=True)
        n = len(params)
        return BatchGrads(loss=loss.detach(), l1=l1_sum / wsum,
                          params=G.GaussianParams(*grads[:n]),
                          deform=list(grads[n:-1]), tap=grads[-1],
                          radii=radii, tile_overflow=overflow,
                          dup_total=dups)

    return loss_and_grads


def make_batched_step(*, opt_cfg, pipe_cfg, model_cfg, field,
                      update_gaussians: bool, update_deform: bool,
                      use_deform: bool):
    """-> step(state, deform_state, cams, iteration, bg, wts=None) ->
    (state, deform_state, StepAux): the k-camera loss and backward, then
    the masked Gaussian Adam with the densification statistics (unless
    Gaussians are frozen or not updated) and the deform Adam."""
    loss_and_grads = make_batched_loss_and_grads(
        opt_cfg=opt_cfg, pipe_cfg=pipe_cfg, model_cfg=model_cfg,
        field=field, use_deform=use_deform)

    def step(state: G.GaussianState, deform_state, cams: list[Camera],
             iteration, bg, wts=None):
        r = loss_and_grads(state, cams, bg, wts)
        return apply_updates(state, deform_state, r, iteration,
                             opt_cfg=opt_cfg, field=field,
                             update_gaussians=update_gaussians,
                             update_deform=update_deform)

    return step


@torch.no_grad()
def apply_updates(state: G.GaussianState, deform_state, r: BatchGrads,
                  iteration, *, opt_cfg, field, update_gaussians: bool,
                  update_deform: bool):
    """The end of a flagship step from its gradients `r` (this rank's rows
    and reduced gradients, for the sharded steps): the masked Gaussian Adam
    with the densification statistics (unless Gaussians are frozen or not
    updated) and the deform Adam. -> (state, deform_state, StepAux)."""
    if update_gaussians and not opt_cfg.freeze_gaussians:
        lrs = G.group_learning_rates(opt_cfg, iteration,
                                     state.spatial_lr_scale)
        params, opt = G.adam_step(state.params, r.params, state.opt, lrs,
                                  mask=state.alive)
        state = G.add_densification_stats(
            dataclasses.replace(state, params=params, opt=opt), r.tap,
            r.radii)
    if update_deform and deform_state is not None:
        deform_state = field.update(deform_state, r.deform, iteration)
    aux = StepAux(loss=r.loss, l1=r.l1, radii=r.radii,
                  tile_overflow=r.tile_overflow, dup_total=r.dup_total)
    return state, deform_state, aux


@dataclass
class IterativeSchedule:
    """Alternating-update schedule (train.py:296-321): switch between
    updating deform-only and gaussians-only every `interval` iterations,
    decaying the interval by `decay` at each switch, for at most
    `max_switches` switches — then update both simultaneously."""
    enabled: bool
    interval: float
    decay: float
    max_switches: int
    switches_done: int = 0
    next_switch: float = 0.0
    phase_deform: bool = True

    def mode(self, iteration: int) -> tuple[bool, bool]:
        """-> (update_gaussians, update_deform) at `iteration`."""
        if not self.enabled or self.switches_done >= self.max_switches:
            return True, True
        if self.next_switch == 0.0:
            self.next_switch = self.interval
        if iteration >= self.next_switch:
            self.phase_deform = not self.phase_deform
            self.switches_done += 1
            self.interval *= self.decay
            self.next_switch = iteration + self.interval
        return (not self.phase_deform, self.phase_deform)


class BatchPicker:
    """The JAX trainer's `pick_batch`: k cameras popped at `rng.randint`
    from the fid-sorted (optionally `spread_out_sequence` subsampled)
    stack, refilled when fewer than k remain, padded to a multiple of
    `pad_to` (the ranks that split the batch) with cameras picked again at
    `rng.randint`, returned sorted by fid. `weights(batch)` are 1/copies
    of each camera, so the padded batch's weighted mean is the unpadded
    mean."""

    def __init__(self, train_cams: list[Camera], *, k: int,
                 sequence_length: int, spread_out: bool, seed: int,
                 pad_to: int = 1):
        self.train_cams, self.k, self.pad_to = train_cams, k, pad_to
        self.sequence_length, self.spread_out = sequence_length, spread_out
        self.rng = Random(seed)
        self.stack: list[Camera] = []

    def __call__(self) -> list[Camera]:
        if len(self.stack) < self.k:
            full = sorted(self.train_cams, key=lambda c: float(c.fid))
            if self.spread_out:
                full = subsample_stack(full, self.sequence_length)
            self.stack = full
        n_pick = max(1, min(self.k, len(self.stack)))
        picked = [self.stack.pop(self.rng.randint(0, len(self.stack) - 1))
                  for _ in range(n_pick)]
        while len(picked) % self.pad_to:
            picked.append(picked[self.rng.randint(0, len(picked) - 1)])
        picked.sort(key=lambda c: float(c.fid))
        return picked

    @staticmethod
    def weights(batch: list[Camera]) -> list[float]:
        return [1.0 / sum(c is d for d in batch) for c in batch]


def train_flagship(
    *,
    gaussians: G.GaussianState,
    train_cams: list[Camera],
    test_cams: list[Camera],
    cameras_extent: float,
    model_cfg,
    opt_cfg,
    pipe_cfg,
    base_model_frozen: bool = False,
    field=None,
    deform_state=None,
    mesh=None,
    test_iterations=(),
    save_iterations=(),
    model_path: str = "",
    seed: int = 0,
    log_every: int = 50,
    tb_writer=None,
    progress: bool = True,
) -> TrainResult:
    """Train `gaussians` and the deform field of `pick_field_spec` (fresh
    from torch.Generator(seed) unless `field` and `deform_state` are
    given). `tb_writer` gets the JAX flagship trainer's tags (the
    baseline's without l1). With `mesh` (a `parallel.mesh.Mesh`) every
    rank calls this with the same arguments; the returned state is the
    whole state on every rank."""
    dev = gaussians.alive.device
    gen = torch.Generator().manual_seed(seed)
    if field is None:
        field = create_deform_field(pick_field_spec(model_cfg, opt_cfg),
                                    seed=seed, device=dev, opt_cfg=opt_cfg)
        deform_state = field.init_state()
    bg = torch.full((3,), 1.0 if model_cfg.white_background else 0.0,
                    device=dev)

    gauss_tile = mesh is not None and pipe_cfg.mesh_mode == "gauss_tile"
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        from ..parallel import mesh as M
        from ..parallel import sharded as S
        M.replicate(field.net)
    steps = {}

    def get_step(use_d, upd_g, upd_d):
        key = (use_d, upd_g, upd_d)
        if key not in steps:
            kw = dict(opt_cfg=opt_cfg, pipe_cfg=pipe_cfg,
                      model_cfg=model_cfg, field=field,
                      update_gaussians=upd_g, update_deform=upd_d,
                      use_deform=use_d)
            if gauss_tile:
                steps[key] = S.make_flagship_gauss_tile_step(
                    mesh, width=train_cams[0].width,
                    height=train_cams[0].height, **kw)
            elif mesh is not None:
                steps[key] = S.make_flagship_camera_parallel_step(mesh, **kw)
            else:
                steps[key] = make_batched_step(**kw)
        return steps[key]

    def whole(st):
        """The whole state (every rank of the row takes part)."""
        return M.gather_gaussian_state(st, mesh) if gauss_tile else st

    eval_render = make_eval_render(
        pipe_cfg=pipe_cfg, is_6dof=model_cfg.is_6dof,
        direct_compute=opt_cfg.direct_compute and field.spec.kind in ODE_KINDS,
        deform_fn=lambda xyz, fid, it, g: field.step(xyz, fid, y0=xyz))
    schedule = IterativeSchedule(
        enabled=opt_cfg.use_iterative_update,
        interval=float(opt_cfg.iterative_update_interval),
        decay=opt_cfg.iterative_update_decay,
        max_switches=opt_cfg.max_training_switches)
    # camera-split batches pad to a multiple of the ranks that split them:
    # all of them in the camera layout, the camera groups of a 2D
    # gauss_tile mesh (a 1D one renders every camera on every rank)
    pad_to = 1 if mesh is None else (mesh.cam if gauss_tile else mesh.size)
    pick_batch = BatchPicker(
        train_cams, k=opt_cfg.num_cams_per_iter,
        sequence_length=opt_cfg.sequence_length,
        spread_out=opt_cfg.spread_out_sequence, seed=seed, pad_to=pad_to)
    densify_allowed = not base_model_frozen

    state = gaussians
    if gauss_tile:
        state = M.shard_gaussian_state(state, mesh)
    elif mesh is not None:
        M.replicate(list(state.params))
    result = TrainResult(state=state, field=field, deform_state=deform_state)
    ema_loss = 0.0
    t0 = time.perf_counter()
    timer = IterTimer()
    for iteration in range(1, opt_cfg.iterations + 1):
        if iteration % 1000 == 0:
            state = G.oneup_sh_degree(state)
        cams = pick_batch()
        wts = BatchPicker.weights(cams) if pad_to > 1 else None
        warm = iteration < opt_cfg.warm_up
        if warm:
            upd_g, upd_d, use_d = True, False, False
        else:
            (upd_g, upd_d), use_d = schedule.mode(iteration), True
        step = get_step(use_d, upd_g, upd_d)
        state, new_dstate, aux = step(state, None if warm else deform_state,
                                      cams, iteration, bg, wts)
        if not warm:
            deform_state = new_dstate

        logged = iteration % log_every == 0 or iteration == 1
        evaluated = iteration in test_iterations
        saved = iteration in save_iterations and model_path
        view = whole(state) if logged or evaluated or saved else None
        if logged:
            loss_val = float(aux.loss)
            ema_loss = 0.4 * loss_val + 0.6 * ema_loss
            result.losses.append((iteration, loss_val))
            if tb_writer is not None and lead:
                log_scalars(tb_writer, iteration, loss_val, view,
                            timer(iteration))
            if progress and lead:
                print(f"[flagship {iteration}/{opt_cfg.iterations}] loss "
                      f"{ema_loss:.4f} (step {loss_val:.9g}) points "
                      f"{view.num_alive} {time.perf_counter() - t0:.1f} s",
                      flush=True)

        if evaluated and lead:
            mean_psnr, eval_imgs = evaluate(
                eval_render, view, iteration >= opt_cfg.warm_up,
                test_cams or train_cams[:5], bg)
            result.test_psnrs[iteration] = mean_psnr
            if tb_writer is not None:
                log_evaluation(tb_writer, iteration, mean_psnr, view,
                               eval_imgs, first=iteration == min(
                                   test_iterations))
            if progress:
                print(f"[ITER {iteration}] evaluating test: PSNR "
                      f"{mean_psnr:.4f}", flush=True)
            if mean_psnr > result.best_psnr:
                result.best_psnr = mean_psnr
                result.best_iteration = iteration

        if saved and lead:
            save_checkpoint(model_path, iteration, view, field)

        if (densify_allowed and iteration < opt_cfg.densify_until_iter
                and densify_due(iteration, opt_cfg, model_cfg)):
            # on the whole state, with the same generator on every rank
            full = densify_cadence(whole(state), iteration, opt_cfg=opt_cfg,
                                   model_cfg=model_cfg, gen=gen,
                                   cameras_extent=cameras_extent,
                                   events=result.densify_events)
            state = M.shard_gaussian_state(full, mesh) if gauss_tile \
                else full

    result.state = whole(state)
    result.deform_state = deform_state
    return result
