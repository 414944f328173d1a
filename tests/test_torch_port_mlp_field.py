"""The fused deformation MLP (`d3gs_tpu_torch/ops/mlp_field.py`, kernels
`csrc/mlp_field.cu`) on the CPU:

  * the .cu itself, built by g++ against a stand-in of the CUDA runtime
    (`tests/torch_port_cuda_host.py`), driven through the wrapper's own
    launch code (`_forward_kernel`, `_vjp_kernel`) on CPU tensors and held
    against the plain versions `mlp_field_torch` / `mlp_field_vjp_torch`.
    The tiles are planned for HOST_SMS = 2 SMs: N = 5 is a 64-row tail
    alone, N = 300 two 128-row blocks of a whole wave and a 64-row tail;
  * the plain versions against `DeformMLP`'s own layers and autograd;
  * `DeformMLP.forward` through `_FusedMLP` (the plain versions on the CPU,
    by `DEVICES`), and the rule `engages` on each case it leaves to the
    layers.

The card runs the kernels in `chip_smoke.py`, phase 3e."""
from __future__ import annotations

import ctypes

import pytest
import torch

from d3gs_tpu_torch import tracing
from d3gs_tpu_torch.models.deform.networks import DeformMLP
from d3gs_tpu_torch.ops import mlp_field as M
from tests import torch_port_cuda_host as H
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

T = 0.37


@pytest.fixture(autouse=True)
def clean():
    tracing.drain()
    yield
    tracing.drain()


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    if H.compiler() is None:
        pytest.skip("no g++ to build the kernel source for the CPU")
    lib = H.build("mlp_field", tmp_path_factory.mktemp("mlp_field"))
    fwd, bwd = lib.d3gs_mlp_field, lib.d3gs_mlp_field_bwd
    fwd.argtypes, fwd.restype = M._ARGTYPES, ctypes.c_int
    bwd.argtypes, bwd.restype = M._ARGTYPES_BWD, ctypes.c_int
    return fwd, bwd


def _net(seed: int = 0, **kw) -> DeformMLP:
    return DeformMLP(generator=torch.Generator().manual_seed(seed), **kw)


def _points(n: int, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 3), generator=g) * 2.6 - 1.3


def _cotangents(heads, seed: int = 2) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(h.shape, generator=g) for h in heads]


def _l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("n, is_blender, full_heads, splits", [
    (5, True, True, 2), (300, False, True, 1), (300, True, False, 2),
    (5, False, False, 1)])
def test_kernel_source_matches_plain(entries, n, is_blender, full_heads,
                                     splits, monkeypatch):
    """The heads within 2e-6 of the plain version's largest head (the same
    arithmetic, the products summed in another order: the gaps read up to
    6e-7, ~4e-8 at heads of ~0.05-0.1, a few ulps), bit-equal with and
    without the kept scratch; every parameter's gradient, 1-2 K-splits
    summed, within 2e-6 (relative L2) of the plain VJP's (gaps up to
    ~7e-7)."""
    monkeypatch.setenv("HOST_SMS", "2")
    fwd, bwd = entries
    net = _net(n, is_blender=is_blender, full_heads=full_heads)
    x = _points(n)
    heads, kept = M._forward_kernel(fwd, net, x, T, True, None)
    alone, none = M._forward_kernel(fwd, net, x, T, False, None)
    assert tracing.counters() == {"launches.mlp_field": 2} and none is None
    want = M.mlp_field_torch(net, x, T)
    assert len(heads) == len(want) == (3 if full_heads else 1)
    for a, b, c in zip(heads, alone, want):
        assert torch.equal(a, b)
        gap = float((a - c).abs().max() / c.abs().max())
        assert gap <= 2e-6, gap
    gs = _cotangents(want)
    got = M._vjp_kernel(bwd, net, x, T, gs, kept, None, splits, None)
    assert M.launch_counts() == {"mlp_field": 2, "mlp_field_bwd": 1}
    ref = M.mlp_field_vjp_torch(net, x, T, gs)
    for (name, _), a, b in zip(net.named_parameters(), got, ref):
        assert a.shape == b.shape, name
        assert _l2(a, b) <= 2e-6, (name, _l2(a, b))


@pytest.mark.parametrize("is_blender", [True, False],
                         ids=["blender", "pe_time"])
@pytest.mark.parametrize("full_heads", [True, False], ids=["heads", "warp"])
def test_plain_versions_match_the_layers(is_blender, full_heads):
    """`mlp_field_torch` and `mlp_field_vjp_torch` against DeformMLP's own
    layers (concat, PE(t) or the time net per point) and autograd: the
    kernels' form changes only the order of sums (heads within 2e-6 of the
    largest, as the kernel's; gradients within 2e-6, relative L2)."""
    net = _net(3, is_blender=is_blender, full_heads=full_heads)
    x = _points(200)
    params = list(net.parameters())
    with torch.enable_grad():
        out = [o for o in net(x, T) if isinstance(o, torch.Tensor)]
        gs = _cotangents(out)
        want = torch.autograd.grad(out, params, gs)
    assert tracing.counters() == {"deform.mlp.evals": 1}
    for a, b in zip(M.mlp_field_torch(net, x, T), out):
        assert float((a - b).abs().max() / b.abs().max()) <= 2e-6
    got = M.mlp_field_vjp_torch(net, x, T, gs)
    for (name, _), a, b in zip(net.named_parameters(), got, want):
        assert _l2(a, b) <= 2e-6, (name, _l2(a, b))


def test_fused_path_under_autograd(monkeypatch):
    """DeformMLP.forward through `_FusedMLP` (the plain versions on the
    CPU): the heads and the gradients of the parameters that take one
    (the heads frozen here: None) as the layers' own, counted as fused;
    without autograd, the forward alone."""
    monkeypatch.setattr(M, "DEVICES", ("cuda", "cpu"))
    net = _net(4)
    x = _points(64)
    for lin in net.heads[1:]:
        lin.requires_grad_(False)
    params = [p for p in net.parameters() if p.requires_grad]
    out = net(x, T)
    assert tracing.counters() == {"deform.mlp.evals": 1,
                                  "deform.mlp.fused": 1}
    assert all(o.grad_fn is not None for o in out)
    gs = _cotangents(out)
    got = torch.autograd.grad(out, params, gs)
    with monkeypatch.context() as m:
        m.setattr(M, "DEVICES", ())
        ref = net(x, T)
        want = torch.autograd.grad(ref, params, gs)
    for a, b in zip(out, ref):
        assert float((a - b).abs().max() / b.abs().max()) <= 2e-6
    for a, b in zip(got, want):
        assert _l2(a, b) <= 2e-6
    tracing.drain()
    with torch.no_grad():
        warp = _net(5, full_heads=False)(x, T)
    assert tracing.counters() == {"deform.mlp.evals": 1,
                                  "deform.mlp.fused": 1}
    assert warp[0].shape == (64, 3) and warp[1:] == (0.0, 0.0)


@pytest.mark.parametrize("case", [
    "qualifies", "x_grad_off", "cpu_input", "bfloat16", "is_6dof",
    "width_128", "depth_6", "multires_6", "tensor_t", "per_point_t",
    "x_requires_grad", "float64_x"])
def test_dispatch_rule(case, monkeypatch):
    """Only an f32 8x256 DeformMLP (PE(x, 10), no 6DoF head) on an (N, 3)
    f32 x of a device in `DEVICES` that takes no gradient, at a host
    number t, takes the fused path; everything else keeps the layers, with
    what they computed before."""
    if case != "cpu_input":
        monkeypatch.setattr(M, "DEVICES", ("cuda", "cpu"))
    kw = {"bfloat16": dict(compute_dtype="bfloat16"),
          "is_6dof": dict(is_6dof=True), "width_128": dict(W=128),
          "depth_6": dict(D=6), "multires_6": dict(multires=6)}.get(case, {})
    net = _net(6, **kw)
    x = _points(40)
    t = T
    if case == "tensor_t":
        t = torch.tensor(T)
    elif case == "per_point_t":
        t = torch.full((40, 1), T)
    elif case == "x_requires_grad":
        x.requires_grad_()
    elif case == "float64_x":
        x = x.double()
    engaged = case in ("qualifies", "x_grad_off")
    with torch.set_grad_enabled(case != "x_grad_off"):
        if case == "x_grad_off":
            x.requires_grad_()
        assert M.engages(net, x, t) == engaged
        out = net(x, t)
    counts = tracing.counters()
    assert counts.get("deform.mlp.fused", 0) == int(engaged)
    assert counts["deform.mlp.evals"] == 1
    assert M.launch_counts() == {"mlp_field": 0, "mlp_field_bwd": 0}
    if not engaged:
        # the layers, as before: the wrapper takes none of these cases
        with monkeypatch.context() as m:
            m.setattr(M, "engages", lambda *a: False)
            again = net(x, t)
        for a, b in zip(out, again):
            assert torch.equal(a, b)


def test_wrapper_checks_its_inputs():
    net = _net()
    x = _points(4)
    with pytest.raises(ValueError, match="host number"):
        M.mlp_field_torch(net, x, torch.zeros((4, 1)))
    with pytest.raises(ValueError, match=r"\(N, 3\) float32"):
        M.mlp_field_torch(net, x.double(), T)
    with pytest.raises(ValueError, match="DeformMLP"):
        M.mlp_field_torch(_net(is_6dof=True), x, T)
    with pytest.raises(ValueError, match="cotangent"):
        M.mlp_field_vjp_torch(net, x, T, [torch.zeros(4, 3)] * 2
                              + [torch.zeros(4, 4)])


@pytest.mark.parametrize("module", ["ode_rk4", "mlp_field"])
def test_ops_import_no_models(module):
    """The fused kernels' modules sit below the nets that dispatch to them:
    importing one imports nothing of `d3gs_tpu_torch.models`."""
    import subprocess
    import sys
    code = (f"import sys; import d3gs_tpu_torch.ops.{module}; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('d3gs_tpu_torch.models')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_qualifies_tells_the_nets_apart():
    """Each wrapper's rule reads the net's attributes alone: the MLP
    kernels take the 8x256 DeformMLP and not the ODE net with the same
    trunk, the RK4 kernels the reverse."""
    from d3gs_tpu_torch.models.deform.networks import DeformNetworkODE
    from d3gs_tpu_torch.ops import ode_rk4 as K
    mlp, ode = _net(), DeformNetworkODE()
    assert M.qualifies(mlp) and not M.qualifies(ode)
    assert K.qualifies(ode) and not K.qualifies(mlp)
    assert not M.qualifies(lambda t, y: y) and not K.qualifies(
        lambda t, y: y)
