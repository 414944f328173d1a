"""The fused RK4 step of the 8x256 ODE dynamics net (`d3gs_tpu_torch/ops/
ode_rk4.py`, kernels `csrc/ode_rk4.cu` and `csrc/ode_rk4_bwd.cu`) on the
CPU: its plain version against today's `_rk4_step`, the plain version of
its vector-Jacobian product against autograd through `_rk4_step`, the
autograd Function of a fused substep against the checkpointed path, the
rule by which `_substep` takes the fused path, and the evaluation
counters. The kernels themselves run only on the card (`chip_smoke.py`,
phase 3d); here the fused path is made to run on CPU states by adding
"cpu" to `ode_rk4.DEVICES`, where it takes the plain versions."""
from __future__ import annotations

import pytest
import torch

from d3gs_tpu_torch import tracing
from d3gs_tpu_torch.models.deform import ode as O
from d3gs_tpu_torch.models.deform.fields import (DeformFieldSpec,
                                                 create_deform_field)
from d3gs_tpu_torch.models.deform.networks import (DeformNetworkODE,
                                                   positional_encoding)
from d3gs_tpu_torch.ops import ode_rk4 as K
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

N = 300                       # not a multiple of the kernel's 128-row tile
GRID = [0.1, 0.3, 0.42, 0.7]  # three segments
SUBSTEPS = 2


@pytest.fixture(autouse=True)
def clean():
    tracing.drain()
    yield
    tracing.drain()


def _net(seed: int = 0, **kw) -> DeformNetworkODE:
    return DeformNetworkODE(generator=torch.Generator().manual_seed(seed),
                            **kw)


def _state(seed: int = 1, n: int = N) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 3), generator=g) * 2.6 - 1.3


@pytest.mark.parametrize("is_blender", [True, False],
                         ids=["blender", "pe_time"])
@pytest.mark.parametrize("scale", [1.0, 0.6])
def test_plain_version_matches_rk4_step(is_blender, scale):
    """Folded time bias, split skip, the stage arithmetic in order: one
    step within 1e-6 of the largest |y| of today's step."""
    net = _net(is_blender=is_blender, output_scale=scale)
    y = _state()
    with torch.no_grad():
        for t, dt in ((0.0, 0.09125), (0.35, 0.0375)):
            want = O._rk4_step(net, y, t, dt)
            got = K.rk4_step_torch(net, y, t, dt)
            assert got.shape == (N, 3)
            assert float((got - want).abs().max()) <= \
                1e-6 * float(want.abs().max())
            assert float((got - y).abs().max()) > 1e-3   # the step moves y


def test_time_biases_fold_the_time_input():
    """c0 and c5 are the time part of layer 0 and of the skip layer plus
    their biases: with them, the x part alone gives the layers' outputs."""
    net = _net(is_blender=True)
    y = _state(n=5)
    pk = K._packed(net)
    t = 0.37
    with torch.no_grad():
        tb = K.time_biases(net, [t], y)
        t_emb = net.timenet[1](torch.relu(net.timenet[0](
            positional_encoding(torch.full((5, 1), t), net.t_multires))))
        x_emb = positional_encoding(y, K.MULTIRES)
        inp = torch.cat([x_emb, t_emb], 1)
        torch.testing.assert_close(
            x_emb @ pk.w0_x.T + tb[0, 0], net.trunk[0](inp),
            rtol=0, atol=1e-6)
        h = torch.rand((5, 256))
        torch.testing.assert_close(
            x_emb @ pk.w5_x.T + h @ pk.w5_h.T + tb[0, 1],
            net.trunk[5](torch.cat([inp, h], 1)), rtol=0, atol=1e-5)


def test_packed_weights_follow_in_place_updates():
    """The kernel's packed weights are rebuilt when a parameter changes in
    place (an optimizer step), and reused otherwise."""
    net = _net()
    first = K._packed(net)
    assert K._packed(net) is first
    with torch.no_grad():
        net.trunk[3].weight.mul_(0.5)
    second = K._packed(net)
    assert second is not first
    torch.testing.assert_close(second.w[64 + 2 * 256:64 + 3 * 256],
                               net.trunk[3].weight.detach().T)
    assert second.w.shape == (K.PACKED_ROWS, 256)


def _loss_and_grads(net, y0, ts):
    y0 = y0.clone().requires_grad_()
    ys = O.odeint_grid(net, y0, ts, n_substeps=SUBSTEPS)
    w = torch.linspace(-1.0, 1.0, ys.numel()).reshape(ys.shape)
    loss = (ys * w).sum()
    params = list(net.parameters())
    return ys.detach(), torch.autograd.grad(loss, [y0] + params)


def test_fused_substep_gradients_match_checkpoint(monkeypatch):
    """Through a 3-segment `odeint_grid`, the fused substeps' Function and
    the checkpointed `_rk4_step` give the same trajectory and the same
    gradients of the state and of every parameter. The forwards differ by
    rounding (the folded bias), and the ReLU trunk's gradient is
    ill-conditioned in f32: a change of the state by rounding flips units
    near their kink. So each leaf's gap (relative L2) is held to the
    control's, the checkpointed path against itself with the input moved
    by one ulp (2e-3 for the state, 4e-5 to 1.4e-3 for the parameters;
    the fused gaps read 3-8 times less: the fused backward differentiates
    the kernel's form of the net, whose rounding differs), and to 1e-3.
    The fused backward is the step's VJP, counted as a fused recompute."""
    net = _net(is_blender=True, output_scale=0.8)
    y0 = _state()
    ys_ref, g_ref = _loss_and_grads(net, y0, GRID)
    _, g_moved = _loss_and_grads(net, y0 * (1 + 2.0 ** -23), GRID)
    _, counts = tracing.drain()
    assert "ode.evals.fused" not in counts
    monkeypatch.setattr(K, "DEVICES", ("cuda", "cpu"))
    ys, g = _loss_and_grads(net, y0, GRID)
    _, counts = tracing.drain()
    evals = 4 * SUBSTEPS * (len(GRID) - 1)
    assert counts["ode.evals.fused"] == 2 * evals
    assert counts["ode.evals.forward"] == evals
    assert counts["ode.evals.recompute"] == evals
    assert float((ys - ys_ref).abs().max()) <= 1e-6
    names = ["y0"] + [n for n, _ in net.named_parameters()]
    assert len(g) == len(names) == 23
    for name, a, b, c in zip(names, g, g_ref, g_moved):
        gap = float((a - b).norm() / b.norm())
        control = float((c - b).norm() / b.norm())
        assert gap <= min(1e-3, control), (name, gap, control)


@pytest.mark.parametrize("case", [
    "qualifies", "cpu_state", "per_sample_grid", "use_linear_1",
    "use_linear_2", "use_linear_3", "use_linear_4", "width_128",
    "adaptive", "simple_start", "float64_state",
])
def test_dispatch_rule(case, monkeypatch):
    """Only the 8x256 full-MLP DeformNetworkODE with PE, on a float32
    state of a device in `DEVICES`, on a shared grid of host times takes
    the fused path; everything else keeps `_rk4_step`, checkpointed under
    autograd."""
    if case != "cpu_state":
        monkeypatch.setattr(K, "DEVICES", ("cuda", "cpu"))
    spec = dict(kind="ode", is_blender=True, n_substeps=SUBSTEPS)
    y0 = _state(n=40)
    ts = [0.2, 0.5]
    if case.startswith("use_linear_"):
        # the affine ablation maps the state itself (63 dims under PE)
        spec.update(use_linear=int(case[-1]), use_emb=case != "use_linear_2")
    elif case == "width_128":
        spec["W"] = 128
    elif case == "adaptive":
        spec["solver"] = "adaptive"
    elif case == "simple_start":
        spec = dict(kind="simple_start", n_substeps=SUBSTEPS)
    elif case == "per_sample_grid":
        ts = torch.stack([torch.full((40,), 0.2),
                          torch.linspace(0.4, 0.6, 40)], 1)
    elif case == "float64_state":
        y0 = y0.double()
    field = create_deform_field(DeformFieldSpec(**spec), seed=3,
                                device="cpu")
    if case == "float64_state":
        field.net.double()
    checkpoints = []
    real = O.checkpoint
    monkeypatch.setattr(O, "checkpoint", lambda *a, **k: (
        checkpoints.append(1), real(*a, **k))[1])
    ys = field.step_multi(y0, ts, y0=y0)[0]
    ys.square().sum().backward()
    counts = tracing.counters()
    engaged = case == "qualifies"
    assert ("ode.evals.fused" in counts) == engaged
    # the plain versions
    assert K.launch_counts() == {"ode_rk4": 0, "ode_rk4_bwd": 0}
    if case == "adaptive":
        assert "ode.evals.forward" not in counts and not checkpoints
    else:
        assert counts["ode.evals.forward"] == 4 * SUBSTEPS
        assert counts["ode.evals.recompute"] == 4 * SUBSTEPS
        assert len(checkpoints) == (0 if engaged else SUBSTEPS)


@pytest.mark.parametrize("grad", [False, True], ids=["nograd", "autograd"])
def test_counters(grad, monkeypatch):
    """A fused step counts its 4 evaluations under the old names
    (`ode.evals.nograd`, or `.forward` and `.recompute` in the backward)
    and again under `ode.evals.fused`, the backward's recompute too: it
    runs inside the fused VJP."""
    monkeypatch.setattr(K, "DEVICES", ("cuda", "cpu"))
    net = _net()
    y0 = _state(n=20).requires_grad_(grad)
    steps = 3
    with torch.set_grad_enabled(grad):
        y = O.integrate_segment(net, y0, 0.0, 0.6, steps)
    counts = tracing.counters()
    assert counts["ode.evals.fused"] == 4 * steps
    if not grad:
        assert counts == {"ode.evals.nograd": 4 * steps,
                          "ode.evals.fused": 4 * steps}
        return
    assert counts == {"ode.evals.forward": 4 * steps,
                      "ode.evals.fused": 4 * steps}
    y.sum().backward()
    assert tracing.counters() == {"ode.evals.forward": 4 * steps,
                                  "ode.evals.fused": 8 * steps,
                                  "ode.evals.recompute": 4 * steps}


def test_wrapper_checks_its_inputs():
    net = _net()
    y = _state(n=4)
    with pytest.raises(ValueError, match="host numbers"):
        K.rk4_step_torch(net, y, torch.zeros((4, 1)), 0.1)
    with pytest.raises(ValueError, match=r"\(N, 3\) float32"):
        K.rk4_step_torch(net, y.double(), 0.0, 0.1)
    with pytest.raises(ValueError, match="DeformNetworkODE"):
        K.rk4_step_torch(_net(W=128), y, 0.0, 0.1)


def _autograd_vjp(net, y, t, dt, g):
    """dL/dy and every parameter's dL/dp through today's `_rk4_step`."""
    y_ = y.clone().requires_grad_()
    out = O._rk4_step(net, y_, t, dt)
    return torch.autograd.grad(out, [y_, *net.parameters()], g)


@pytest.mark.parametrize("is_blender", [True, False],
                         ids=["blender", "pe_time"])
@pytest.mark.parametrize("scale", [1.0, 0.6])
@pytest.mark.parametrize("n", [N, 37])
def test_plain_vjp_matches_autograd(is_blender, scale, n):
    """`rk4_step_vjp_torch` (the kernel's form: folded time bias, split
    skip, the reverse sweep by hand) against autograd through `_rk4_step`:
    dL/dy and every leaf, the time net's included. The forwards differ by
    rounding, which flips ReLU units at their kink, so each leaf's gap
    (relative L2) is held to the control's, autograd against itself with
    the input moved by one ulp (4e-6 to 9e-3 here), or to 1e-5, and to
    1e-2. The gaps read ~3e-7, but 1.8e-3 in the PE-time net at scale 1
    and N = 300, where a unit sits at its kink."""
    net = _net(is_blender=is_blender, output_scale=scale)
    y = _state(n=n)
    g = torch.randn((n, 3), generator=torch.Generator().manual_seed(5))
    t, dt = 0.35, 0.0375
    want = _autograd_vjp(net, y, t, dt, g)
    moved = _autograd_vjp(net, y * (1 + 2.0 ** -23), t, dt, g)
    gy, grads = K.rk4_step_vjp_torch(net, y, t, dt, g)
    got = [gy, *grads]
    names = ["y"] + [name for name, _ in net.named_parameters()]
    assert len(got) == len(want) == (23 if is_blender else 19)
    for name, a, b, c in zip(names, got, want, moved):
        assert a.shape == b.shape, name
        gap = float((a - b).norm() / b.norm())
        control = float((c - b).norm() / b.norm())
        assert gap <= min(1e-2, max(1e-5, control)), (name, gap, control)


@pytest.mark.parametrize("case", ["params_only", "state_only", "frozen_time",
                                  "output_layer_only"])
def test_fused_backward_needs_subsets(case, monkeypatch):
    """The fused substep's Function under `needs_input_grad` subsets: no
    gradient of the state, none of the parameters, the time net and the
    time blocks frozen, and only the output layer's. What is asked for
    matches the checkpointed path (as in the integral's test); what is
    not comes back None from the VJP."""
    net = _net(is_blender=True, output_scale=0.8)
    y0 = _state(n=50)
    names = [name for name, _ in net.named_parameters()]
    if case == "state_only":
        trainable = set()
    elif case == "frozen_time":
        trainable = {name for name in names if not name.startswith(
            ("timenet.", "trunk.0.", "trunk.5."))}
    elif case == "output_layer_only":
        trainable = {"out.weight", "out.bias"}
    else:
        trainable = set(names)
    for name, p in net.named_parameters():
        p.requires_grad_(name in trainable)
    params = [p for name, p in net.named_parameters() if name in trainable]
    with_y = case != "params_only"

    def grads():
        y_ = y0.clone().requires_grad_(with_y)
        ys = O.integrate_segment(net, y_, 0.2, 0.5, SUBSTEPS)
        w = torch.linspace(-1.0, 1.0, ys.numel()).reshape(ys.shape)
        return torch.autograd.grad((ys * w).sum(),
                                   ([y_] if with_y else []) + params)
    want = grads()
    monkeypatch.setattr(K, "DEVICES", ("cuda", "cpu"))
    got = grads()
    assert tracing.counters()["ode.evals.fused"] == 8 * SUBSTEPS
    assert len(got) == len(want) == len(params) + with_y
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) <= 1e-5
    _, gp = K.rk4_step_vjp_torch(
        net, y0, 0.2, 0.15, torch.ones_like(y0),
        [p.requires_grad for p in net.parameters()])
    assert [x is None for x in gp] == [
        name not in trainable for name in names]
