"""The viewing loop: one viewer that waits for each frame (a closed loop).

Frame i's camera orbits the scene at the configuration's camera radius,
one turn and t from 0 to 1 every `period` frames, from frame 0 for every
seed. A frame runs the field at the frame's time (for the ODE field the
integral from 0 to t), the render, and the copy of the image to the host
that a viewer needs; it is delivered when the copy returns. The window
runs frames until `seconds` have passed.

The frames the reference checks are a sample of the window's, drawn from
the seed (a reservoir of `checked_frames`): each is rendered again by the
plain reference after the window and compared with the image the host
received.
"""
from __future__ import annotations

import random
import time

import torch

from .. import budget, counts, program, scene, trace
from ..reference import fields, precision, render
from . import common


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.fref = cfg["field"]

    def _view(self, i: int):
        m = self.mix
        return scene.orbit_view(i, m["period"], self.cfg["radius"],
                                m["elevation_deg"], m["size"],
                                self.cfg["fovx"], self.device)

    def setup(self) -> None:
        cfg, mix, dev = self.cfg, self.mix, self.device
        _, params, alive, weights = common.build(cfg, self.seed, dev)
        self.params, self.alive, self.weights = params, alive, weights
        self.bg = torch.full((3,), float(cfg["background"]), device=dev)
        self.model, self.opt, self.pipe = program.configs(cfg)
        self.state = program.gaussian_state(params, alive, cfg["sh_degree"],
                                            cfg["spatial_lr_scale"])
        self.field = program.deform_field(self.model, self.opt, weights, dev)
        common.check_field(self.field, self.fref)
        empty = torch.empty((0,), device=dev)
        self.orbit = [self._view(i) for i in range(mix["period"])]
        self.cams = [program.camera(v, empty) for v in self.orbit]
        self.frame = 0
        self.failed = 0
        for j in range(1, 1 + mix["warmup_frames"]):
            program.render_frame(self.state, self.field, self.cams[j],
                                 self.bg, self.pipe).image.cpu()
        common.sync(dev)

    def _frame(self, events=None):
        cam = self.cams[self.frame % len(self.cams)]
        out = program.render_frame(self.state, self.field, cam, self.bg,
                                   self.pipe, events)
        image = out.image.cpu()
        self.frame += 1
        return image, out.counts.sum()

    def window(self, seconds: float, traced: bool) -> dict:
        pre_s = max(seconds - self.mix["profile_seconds"], 0.0) if traced \
            else seconds
        rng = random.Random(self.seed)
        size = self.mix["checked_frames"]
        self.sample = []                 # (frame index, host image)
        dups, parts = [], []
        t0 = time.perf_counter()
        while True:
            ev = None
            if traced:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                parts.append(ev)
            i = self.frame
            image, m = self._frame(ev)
            dups.append(m)
            if len(self.sample) < size:
                self.sample.append((i, image))
            else:
                j = rng.randint(0, i)
                if j < size:
                    self.sample[j] = (i, image)
            if time.perf_counter() - t0 >= pre_s:
                break
        common.sync(self.device)
        frames = len(dups)
        r = {"window_s": time.perf_counter() - t0, "window_frames": frames}
        if traced:
            r["deform_ms"] = [a.elapsed_time(b) for a, b, _ in parts]
            r["render_ms"] = [b.elapsed_time(c) for _, b, c in parts]

            def body(step):
                n, t1 = 0, time.perf_counter()
                while n == 0 or (time.perf_counter() - t1
                                 < self.mix["profile_seconds"]):
                    step(self._frame)
                    n += 1
                return n
            n, events = trace.profiled(body)
            r["trace"] = trace.reduce(events)
            r["sub_frames"] = n
            self.last = (self.frame - 1) % len(self.cams)
        m = torch.stack(dups).tolist()
        cap = budget.budget(self.cfg["dup_capacity"])
        self.failed = sum(1 for x in m if x >= cap)
        r.update(dups_sum=sum(m), dups_max=max(m), attempted=frames,
                 failed=self.failed)
        return r

    def finish(self, traced: bool) -> dict:
        """Traced runs: the pairs of the last traced frame, counted by the
        plain reference, the FLOPs per frame, and the forward kernel timed
        again by CUDA events on that frame's inputs."""
        if not traced:
            return {}
        from .. import replay
        v = self.orbit[self.last]
        with precision(False):
            _, pairs = self._reference_image(v)
        n, px = self.cfg["gaussians"], v.width * v.height
        evals = counts.ode_evals([0.0, v.fid],
                                 2 * self.fref.get("n_substeps", 0))
        least, bound = counts.blend_least_s(pairs, n, px, backward=False)
        ev = replay.forward_s(self.state, self.field, [self.cams[self.last]],
                              self.bg, self.pipe)
        return {"pairs": [pairs],
                "flops_per_frame": counts.view_flops(self.fref, n, px, pairs,
                                                     evals),
                "blend_fwd_least_s": [least], "blend_fwd_bound": bound,
                "blend_fwd_events_s": ev}

    def release(self) -> None:
        for name in ("state", "field", "cams"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def _reference_image(self, v):
        xyz = self.params["xyz"]
        if self.fref["kind"] == "ode":
            f = fields.dynamics(self.weights, self.fref)
            means, dr, ds = (fields.from_zero(f, xyz, v.fid,
                                              2 * self.fref["n_substeps"]),
                             0.0, 0.0)
        else:
            dx, dr, ds = fields.mlp(self.weights, self.fref, xyz, v.fid)
            means = xyz + dx
        sp = render.splats_for(self.params, self.alive, means, dr, ds, v)
        return render.image(sp, v.width, v.height, self.bg)

    def reference(self, tf32: bool = False) -> dict:
        """The reference's images of the sampled frames."""
        with precision(tf32):
            return {i: self._reference_image(self.orbit[i % len(self.orbit)])
                    [0].cpu() for i, _ in self.sample}

    def numbers(self, prog: dict, ref: dict) -> dict:
        """Over the sampled frames: the worst frame's mean absolute pixel
        error, and the largest error of any pixel."""
        mae = [float((prog[i] - ref[i]).abs().mean()) for i in ref]
        top = [float((prog[i] - ref[i]).abs().max()) for i in ref]
        return {"image_mae": max(mae), "image_max_abs": max(top),
                "_frames": len(ref)}

    def check(self) -> dict:
        return self.numbers(dict(self.sample), self.reference())
