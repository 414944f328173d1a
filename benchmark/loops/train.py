"""The training loop: a trainer's deform-phase iterations, each step's
state carried into the next as a real run carries it.

Set-up makes the teacher (the configuration's Gaussians and field from the
seed), renders its targets at the mix's training views with the plain
reference, and starts the student from the teacher with its colours and
opacities perturbed. The iteration count starts at the mix's `iteration0`
(past densification in the recipes: no densify, no opacity reset; all SH
bands are active, so the trainers' SH ramp is a no-op), and the learning
rates are that iteration's. Views are drawn without replacement, one per
step by the baseline trainer, k per step by the flagship's `BatchPicker`.
The loss is read on the host every `log_every` iterations, as the
trainers do.

The first `checked_steps` steps, in set-up, are those the reference
follows: their losses, the gradient the optimizer takes at the first (its
first moment over 1 - beta1) and each leaf's change over all of them. The
window then runs whole steps until `seconds` have passed and ends with a
synchronize after the last; its views are those of its completed steps.
"""
from __future__ import annotations

import time

import torch

from .. import budget, counts, program, scene, trace
from ..reference import fields, precision, render
from ..reference import train as ref_train
from . import common

BETA1 = 0.9


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.fref = cfg["field"]
        self.k = cfg["optimization"].get("num_cams_per_iter", 1) \
            if cfg["trainer"] != "baseline" else 1

    # ----------------------------------------------------------- set-up
    def setup(self) -> None:
        cfg, mix, dev = self.cfg, self.mix, self.device
        gen, teacher, alive, weights = common.build(cfg, self.seed, dev)
        self.alive, self.weights0 = alive, weights
        self.model, self.opt, self.pipe = program.configs(cfg)
        self.views = program.training_stack(cfg, self.opt, scene.train_views(
            mix["views"], cfg["radius"], mix["size"], cfg["fovx"], dev))
        self.bg = torch.full((3,), float(cfg["background"]), device=dev)
        t0 = time.perf_counter()
        with precision(False):
            self.targets = self._targets(teacher)
        common.sync(dev)
        t1 = time.perf_counter()
        self.student0 = scene.perturb(teacher, alive, gen, mix["colour_sd"],
                                      mix["opacity_sd"])
        self.state = program.gaussian_state(
            self.student0, alive, cfg["sh_degree"], cfg["spatial_lr_scale"])
        self.field = program.deform_field(self.model, self.opt, weights, dev)
        common.check_field(self.field, self.fref)
        self.dstate = self.field.init_state()
        self.cams = [program.camera(v, t)
                     for v, t in zip(self.views, self.targets)]
        self.index = {id(c): i for i, c in enumerate(self.cams)}
        self.step_fn = program.make_step(cfg, self.model, self.opt,
                                         self.pipe, self.field)
        self.pick = program.picker(cfg, self.opt, self.cams, self.seed)
        self.iteration = mix["iteration0"]
        self.frames = []             # each frame's counts (see make_step)
        self.failed = 0
        common.sync(dev)
        t2 = time.perf_counter()
        self._checked()
        t3 = time.perf_counter()
        for _ in range(mix["warmup_steps"]):
            self._step()
        common.sync(dev)
        self.setup_parts = {"targets_s": t1 - t0, "program_s": t2 - t1,
                            "checked_s": t3 - t2,
                            "warmup_s": time.perf_counter() - t3}

    @torch.no_grad()
    def _deformed(self, xyz, weights, views):
        """(means, d_rotation, d_scaling) of each view by the reference's
        field: the MLP per view, the ODE as one trajectory through the
        views' times from xyz."""
        if self.fref["kind"] == "ode":
            f = fields.dynamics(weights, self.fref)
            ys = fields.trajectory(f, xyz, [v.fid for v in views],
                                   self.fref["n_substeps"])
            return [(ys[i], 0.0, 0.0) for i in range(len(views))]
        out = []
        for v in views:
            dx, dr, ds = fields.mlp(weights, self.fref, xyz, v.fid)
            out.append((xyz + dx, dr, ds))
        return out

    @torch.no_grad()
    def _render(self, params, weights, views) -> list:
        """The reference's (image, composited pairs) of each view."""
        return [render.image(render.splats_for(params, self.alive, *d, v),
                             v.width, v.height, self.bg)
                for v, d in zip(views, self._deformed(params["xyz"],
                                                      weights, views))]

    def _targets(self, teacher: dict) -> list[torch.Tensor]:
        return [img for img, _ in self._render(teacher, self.weights0,
                                               self.views)]

    def _step(self):
        cams = self.pick()
        it = self.iteration
        self.state, self.dstate, aux, frames = self.step_fn(
            self.state, self.dstate, cams, it, self.bg)
        self.frames.extend(frames)
        self.iteration += 1
        if it % self.mix["log_every"] == 0:
            float(aux.loss)
        return cams, aux

    def _checked(self) -> None:
        g_names = ref_train.GAUSSIAN_LEAVES
        f_names = ref_train.field_leaves(self.weights0)
        g0 = [t.clone() for t in self.state.params]
        f0 = [t.detach().clone() for t in program.field_tensors(self.field)]
        self.batches, self.prog = [], {"losses": []}
        for s in range(self.mix["checked_steps"]):
            cams, aux = self._step()
            self.batches.append([self.index[id(c)] for c in cams])
            self.prog["losses"].append(float(aux.loss))
            if s == 0:
                g = [m / (1 - BETA1) for m in self.state.opt.m]
                f = [m / (1 - BETA1)
                     for m in program.field_moments(self.field, self.dstate)]
                self.prog["grad_norms"] = {
                    **common.tensor_norms(g_names, g),
                    **common.tensor_norms(f_names, f)}
        self.prog["change_norms"] = {
            **common.tensor_norms(g_names, [a - b for a, b in zip(
                self.state.params, g0)]),
            **common.tensor_norms(f_names, [a.detach() - b for a, b in zip(
                program.field_tensors(self.field), f0)])}

    # ----------------------------------------------------------- window
    def window(self, seconds: float, traced: bool) -> dict:
        pre_s = max(seconds - self.mix["profile_seconds"], 0.0) if traced \
            else seconds
        dups, views, steps, ends = [], 0, 0, []
        t0 = time.perf_counter()
        while True:
            cams, aux = self._step()
            dups.append(aux.dup_total)
            views += len(cams)
            steps += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= pre_s:
                break
        common.sync(self.device)
        r = {"window_s": time.perf_counter() - t0, "window_views": views,
             "steps_per_s": [sum(1 for e in ends if i <= e < i + 1)
                             for i in range(int(ends[-1]) + 1)],
             "window_steps": steps, "views_per_step": self.k,
             "setup_parts": self.setup_parts}
        if traced:
            def body(step):
                n, t1, last = 0, time.perf_counter(), None
                while n == 0 or (time.perf_counter() - t1
                                 < self.mix["profile_seconds"]):
                    last, aux = step(self._step)
                    dups.append(aux.dup_total)
                    n += 1
                return n, last
            (n, last), events = trace.profiled(body)
            r["trace"] = trace.reduce(events)
            r["sub_views"] = n * len(last)
            self.last_cams = last
        m = torch.stack(dups).tolist()
        per_frame = torch.stack([c.sum() for c in self.frames]).tolist()
        self.frames = []
        cap = budget.budget(self.cfg["dup_capacity"])
        self.failed = sum(1 for x in per_frame if x >= cap)
        r.update(dups_sum=sum(m[:steps]), dups_first=m[0] / self.k,
                 dups_last=m[steps - 1] / self.k, dups_max=max(per_frame),
                 attempted=steps, failed=self.failed)
        return r

    # ------------------------------------------------- after the window
    def finish(self, traced: bool) -> dict:
        """Readings that need work after the window (traced runs): the
        pairs of the last traced step's views, counted by the plain
        reference from the state the traced steps left, the FLOPs per view
        and the blend kernels timed again by CUDA events on that step's
        inputs."""
        if not traced:
            return {}
        views = [self.views[self.index[id(c)]] for c in self.last_cams]
        with precision(False):
            pairs = self._pairs(views)
        n = self.cfg["gaussians"]
        px = views[0].width * views[0].height
        evals = counts.ode_evals([v.fid for v in views],
                                 self.fref.get("n_substeps", 0))
        flops = counts.train_step_flops(self.fref, n, px, len(views),
                                        sum(pairs), evals)
        least = [counts.blend_least_s(p, n, px, backward=True)
                 for p in pairs]
        return {"pairs": pairs, "flops_per_view": flops / len(views),
                "blend_bwd_least_s": [s for s, _ in least],
                "blend_bwd_bound": least[0][1],
                "blend_bwd_events_s": self._replay(views)}

    def _pairs(self, views) -> list[int]:
        params = dict(zip(ref_train.GAUSSIAN_LEAVES, self.state.params))
        weights = [(lin.weight.detach(), lin.bias.detach())
                   for lin in program.layers(self.field)]
        return [n for _, n in self._render(params, weights, views)]

    def _replay(self, views) -> list[float]:
        from .. import replay
        return replay.backward_s(self.state, self.field, self.last_cams,
                                 self.bg, self.pipe, self.cfg)

    def release(self) -> None:
        for name in ("state", "field", "dstate", "step_fn", "pick", "cams"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------ correctness
    def reference(self, tf32: bool = False) -> dict:
        """The reference's readings of the checked steps (in TF32 for the
        control)."""
        opt = dict(self.cfg["optimization"])
        batches = [[self.views[i] for i in b] for b in self.batches]
        target = {id(v): t for v, t in zip(self.views, self.targets)}
        with precision(tf32):
            return ref_train.run(self.student0, self.alive, self.weights0,
                                 self.fref, opt, batches,
                                 lambda v: target[id(v)], self.bg,
                                 self.mix["iteration0"],
                                 self.cfg["spatial_lr_scale"])

    @staticmethod
    def numbers(prog: dict, ref: dict) -> dict:
        """The numbers compared: the worst step's loss gap (relative), the
        worst leaf's gradient-norm and change-norm gaps."""
        loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                        ref["losses"]))
        grad, grad_at = common.norm_gap(prog["grad_norms"],
                                        ref["grad_norms"],
                                        ref["grad_norms"])
        change, change_at = common.norm_gap(prog["change_norms"],
                                            ref["change_norms"],
                                            ref["grad_norms"])
        return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
                "_grad_leaf": grad_at, "_change_leaf": change_at}

    def check(self) -> dict:
        return self.numbers(self.prog, self.reference())
