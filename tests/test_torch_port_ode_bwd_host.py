"""The RK4 step's backward kernels (`d3gs_tpu_torch/csrc/ode_rk4_bwd.cu`)
on the CPU: the .cu itself, built by g++ against a stand-in of the CUDA
runtime (`tests/torch_port_cuda_host.py`), driven through the wrapper's
own launch code (`ode_rk4._vjp_kernel`) on CPU tensors and held against
`rk4_step_vjp_torch`. The tiles are planned for HOST_SMS = 2 SMs, so the
row counts below take each launch shape of the card: whole waves of
128-row blocks with a tail of 64-row (N = 300), 96-row (406) or 128-row
(456) blocks, and a tail alone (5). The card runs the kernels in
`chip_smoke.py`, phase 3d."""
from __future__ import annotations

import ctypes

import pytest
import torch

from d3gs_tpu_torch import tracing
from d3gs_tpu_torch.models.deform.networks import DeformNetworkODE
from d3gs_tpu_torch.ops import ode_rk4 as K
from tests import torch_port_cuda_host as H
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    if H.compiler() is None:
        pytest.skip("no g++ to build the kernel source for the CPU")
    fn = H.build("ode_rk4_bwd", tmp_path_factory.mktemp("ode_rk4_bwd")
                 ).d3gs_ode_rk4_bwd
    fn.argtypes, fn.restype = K._ARGTYPES_BWD, ctypes.c_int
    return fn


@pytest.mark.parametrize("n, is_blender, scale, splits", [
    (300, True, 0.8, 3), (406, False, 1.0, 2), (456, True, 0.6, 1),
    (5, True, 1.0, 4)])
def test_kernel_source_matches_plain_vjp(entry, n, is_blender, scale,
                                         splits, monkeypatch):
    """Every leaf of the kernels' VJP, weight gradients summed over 1-4
    K-splits, within 2e-6 (relative L2) of the plain version's: the same
    arithmetic in another order (the gaps read up to 7e-7)."""
    monkeypatch.setenv("HOST_SMS", "2")
    net = DeformNetworkODE(is_blender=is_blender, output_scale=scale,
                           generator=torch.Generator().manual_seed(n))
    y = torch.rand((n, 3), generator=torch.Generator().manual_seed(1)
                   ) * 2.6 - 1.3
    g = torch.randn((n, 3), generator=torch.Generator().manual_seed(2))
    tracing.drain()
    gy, grads = K._vjp_kernel(entry, net, y, 0.35, 0.0375, g, None, splits,
                              None)
    assert tracing.counters() == {"launches.ode_rk4_bwd": 1}
    want_y, want = K.rk4_step_vjp_torch(net, y, 0.35, 0.0375, g)
    names = ["y"] + [name for name, _ in net.named_parameters()]
    for name, a, b in zip(names, [gy, *grads], [want_y, *want]):
        assert a.shape == b.shape, name
        gap = float((a - b).norm() / b.norm())
        assert gap <= 2e-6, (name, gap)
    tracing.drain()
