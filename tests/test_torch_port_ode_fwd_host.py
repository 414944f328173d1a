"""The fused RK4 step kernel (`d3gs_tpu_torch/csrc/ode_rk4.cu`, the stage
loop of `ode_rk4_common.cuh` that the backward's recompute shares) on the
CPU: the .cu itself, built by g++ against a stand-in of the CUDA runtime
(`tests/torch_port_cuda_host.py`), driven through the wrapper's own launch
code (`ode_rk4._step_kernel`) on CPU tensors and held against
`rk4_step_torch`. The tiles are planned for HOST_SMS = 2 SMs: N = 5 is a
64-row tail alone, N = 300 two 128-row blocks of a whole wave and a 64-row
tail. The card runs the kernel in `chip_smoke.py`, phase 3d."""
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
    fn = H.build("ode_rk4", tmp_path_factory.mktemp("ode_rk4")).d3gs_ode_rk4
    fn.argtypes, fn.restype = K._ARGTYPES, ctypes.c_int
    return fn


@pytest.mark.parametrize("n, is_blender, scale", [(5, True, 1.0),
                                                  (300, False, 0.8)])
def test_kernel_source_matches_plain_step(entry, n, is_blender, scale,
                                          monkeypatch):
    """The kernel's step within two f32 ulps at |y| in [1, 2) (2.4e-7) of
    the plain version's, elementwise: the same arithmetic, the products in
    another order (a few elements read one ulp apart, the rest equal)."""
    monkeypatch.setenv("HOST_SMS", "2")
    net = DeformNetworkODE(is_blender=is_blender, output_scale=scale,
                           generator=torch.Generator().manual_seed(n))
    y = torch.rand((n, 3), generator=torch.Generator().manual_seed(1)
                   ) * 2.6 - 1.3
    tracing.drain()
    got = K._step_kernel(entry, net, y, 0.35, 0.0375, None)
    assert tracing.counters() == {"launches.ode_rk4": 1}
    want = K.rk4_step_torch(net, y, 0.35, 0.0375)
    gap = float((got - want).abs().max())
    assert gap <= 2.4e-7, gap
    tracing.drain()
