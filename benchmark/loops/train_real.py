"""The real-scene training loop: the baseline trainer's deform-phase
iterations on a capture's portrait frames, the field's time jittered by
AST (annealing smooth training).

As `train.py`'s loop (the teacher and the perturbed student, the state
carried from the mix's `iteration0`, one view a step drawn without
replacement from the time-sorted stack, the loss read every `log_every`,
the set-up's first `checked_steps` steps followed by the reference), but:

* the views are the mix's `views` poses on the sphere at `width` x
  `height`, view i seeing t = i / (views - 1);
* the step is `train/step.py::make_train_step` with the trainer's own
  `train/baseline.py::make_deform_fn`, handed a host generator seeded from
  the run's seed as `train_baseline` hands its own: the field sees AST's
  time, and the reference (`reference/ast.py`) draws the same times from a
  generator of its own;
* the checked steps run with the program's spans on, and the time each
  `deform` span records is compared with the reference's (`t_gap`);
* the window snapshots the program's counter `deform.ast` over the steps
  before the profiled sub-window (`ast_evals`), and the sub-window runs
  with spans on, joined with the profiler's trace (`span_readings`,
  `benchmark/spans.py`).
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from d3gs_tpu_torch import tracing
from d3gs_tpu_torch.train.baseline import make_deform_fn
from d3gs_tpu_torch.train.step import make_train_step

from .. import budget, counts, program, scene, spans, trace
from ..reference import ast as ref_ast
from ..reference import precision
from ..reference import train as ref_train
from . import common, train


def views(mix: dict, cfg: dict, device) -> list:
    """The training cameras, sorted by time: view i sees t = i / (count -
    1) from `scene.sphere_pose(i)`, at the mix's width and height."""
    n = mix["views"]
    return [scene.look_at(scene.sphere_pose(i, n, cfg["radius"]),
                          i / max(n - 1, 1), mix["width"], mix["height"],
                          cfg["fovx"], device) for i in range(n)]


def make_step(opt, pipe, model, field, time_interval: float,
              generator: torch.Generator):
    """-> step(state, deform_state, cams, iteration, bg) -> (state,
    deform_state, StepAux, frames): the baseline trainer's deform-phase
    step on cams[0], its field at AST's time (one draw from `generator`
    a step); `frames` holds the frame's duplicate count."""
    one = make_train_step(
        opt_cfg=opt, pipe_cfg=pipe,
        deform_fn=make_deform_fn(field, model, time_interval),
        deform_params=list(field.net.parameters()),
        deform_update_fn=field.update)

    def step(state, ds, cams, it, bg):
        state, ds, aux = one(state, ds, cams[0], it, generator, bg)
        return state, ds, aux, [aux.dup_total]
    return step


def profiled(body):
    """`trace.profiled`, also handing back the trace's
    `baseTimeNanoseconds`, which a join with the program's spans needs:
    -> (what body returned, the complete events, the base)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = body(lambda fn: fn())
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = [e for e in data["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    return out, events, int(data.get("baseTimeNanoseconds", 0))


def spans_off() -> list:
    """Turn the program's spans off and take those recorded, leaving its
    counters as they were (`tracing.drain` clears both)."""
    tracing.disable()
    found, kept = tracing.drain()
    for name, n in kept.items():
        tracing.count(name, n)
    return found


class Loop(train.Loop):
    # ----------------------------------------------------------- set-up
    def setup(self) -> None:
        cfg, mix, dev = self.cfg, self.mix, self.device
        gen, teacher, alive, weights = common.build(cfg, self.seed, dev)
        self.alive, self.weights0 = alive, weights
        self.model, self.opt, self.pipe = program.configs(cfg)
        self.views = program.training_stack(cfg, self.opt,
                                            views(mix, cfg, dev))
        self.time_interval = 1.0 / len(self.views)
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
        self.step_fn = make_step(
            self.opt, self.pipe, self.model, self.field, self.time_interval,
            torch.Generator().manual_seed(int(self.seed) % 2 ** 63))
        self.pick = program.picker(cfg, self.opt, self.cams, self.seed)
        self.iteration = mix["iteration0"]
        self.frames = []
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

    def _checked(self) -> None:
        """`train.Loop._checked` with the program's spans on: the times
        its `deform` spans record, in order, are `self.prog["times"]`."""
        tracing.enable()
        try:
            super()._checked()
        finally:
            found = spans_off()
        self.prog["times"] = [s.attrs.get("t") for s in sorted(
            found, key=lambda s: s.start_ns) if s.name == "deform"]

    # ----------------------------------------------------------- window
    def window(self, seconds: float, traced: bool) -> dict:
        pre_s = max(seconds - self.mix["profile_seconds"], 0.0) if traced \
            else seconds
        dups, views, steps, ends = [], 0, 0, []
        ast0 = tracing.counters().get("deform.ast", 0)
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
             "ast_evals": tracing.counters().get("deform.ast", 0) - ast0,
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
            before = tracing.counters()
            tracing.enable()
            try:
                (n, last), events, base_ns = profiled(body)
            finally:
                found = spans_off()
            r["trace"] = trace.reduce(events)
            if any(s.name == "train.step" for s in found):
                grown = {k: c - before.get(k, 0)
                         for k, c in tracing.counters().items()}
                r["span_readings"] = spans.readings(
                    spans.join(found, events, base_ns), grown, found)
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
        """The pairs of the last traced step's view, counted by the plain
        reference from the state the traced steps left, and the model
        FLOPs of a view (traced runs)."""
        if not traced:
            return {}
        views = [self.views[self.index[id(c)]] for c in self.last_cams]
        with precision(False):
            pairs = self._pairs(views)
        px = views[0].width * views[0].height
        flops = counts.train_step_flops(self.fref, self.cfg["gaussians"], px,
                                        len(views), sum(pairs), 0)
        return {"pairs": pairs, "flops_per_view": flops / len(views)}

    # ------------------------------------------------------ correctness
    def reference(self, tf32: bool = False, jitter: bool = True) -> dict:
        """The reference's readings of the checked steps, each at AST's
        time (at the frame's own time with `jitter` off, the fault the
        check must see), in TF32 for the control; `times` holds the time
        of each step."""
        fids = [self.views[b[0]].fid for b in self.batches]
        times = ref_ast.jittered(fids, self.mix["iteration0"], self.seed,
                                 1.0 / len(self.views),
                                 self.fref["is_blender"] or not jitter)
        batches, target = [], {}
        for b, t in zip(self.batches, times):
            v = self.views[b[0]]._replace(fid=t)
            target[id(v)] = self.targets[b[0]]
            batches.append([v])
        with precision(tf32):
            out = ref_train.run(self.student0, self.alive, self.weights0,
                                self.fref, dict(self.cfg["optimization"]),
                                batches, lambda v: target[id(v)], self.bg,
                                self.mix["iteration0"],
                                self.cfg["spatial_lr_scale"])
        out["times"] = times
        return out

    @staticmethod
    def numbers(prog: dict, ref: dict) -> dict:
        """`train.Loop.numbers` and `t_gap`: the largest difference
        between the time a checked step's `deform` span recorded and the
        reference's time of that step (inf where the counts differ)."""
        out = train.Loop.numbers(prog, ref)
        a, b = prog.get("times", []), ref["times"]
        out["t_gap"] = max(abs(x - y) for x, y in zip(a, b)) \
            if len(a) == len(b) else float("inf")
        return out
