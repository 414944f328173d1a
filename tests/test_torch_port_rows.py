"""The port's row kernels' plain versions (`d3gs_tpu_torch/ops/rows.py`, what
the wrappers run on CPU tensors) against the Pallas kernels of the three
dev tools, run in interpret mode on the CPU, and the tool ports against
their JAX counterparts:

* `row_copy` against `tools/exp_r5_reduce.py::force_rowmajor` / `_id_kernel`
  and `row_gather` against `tools/exp_vmem_gather.py::kernel_take` and
  `::kernel_loop`: exact;
* `scatter_add_rows` against `tools/exp_vmem_scatter.py::kern`: within
  1e-5 of the largest sum (the two add in different orders);
* the port's reduction variants V0-V3 against the JAX tool's V0 on a small
  rank layout: within 1e-5 of the largest sum.

`exp_r5_reduce.py` and `exp_vmem_scatter.py` run their benchmarks at
import, so only their function definitions are loaded (with `ast`), with
the module constants the functions read set to small shapes.
"""
import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from d3gs_tpu_torch.ops import rows as R
from d3gs_tpu_torch.tools import exp_r5_reduce as TR
from d3gs_tpu_torch.tools import exp_vmem_gather as TG
from d3gs_tpu_torch.tools import exp_vmem_scatter as TS
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
# pallas_call in interpret mode; the rest of `pl` as it is
PL_INTERPRET = types.SimpleNamespace(
    pallas_call=functools.partial(pl.pallas_call, interpret=True),
    BlockSpec=pl.BlockSpec, when=pl.when, program_id=pl.program_id,
    ds=pl.ds)


def load_defs(filename: str, names: set, **consts) -> dict:
    """The named top-level functions of tools/<filename>, without running
    the module, in a namespace holding jax, jnp, pl, pltpu and `consts`."""
    path = os.path.join(TOOLS, filename)
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == names
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


@pytest.mark.parametrize("mb,kb", [(16, 128), (24, 128)])
def test_row_copy_matches_id_kernel(mb, kb):
    """V2's input: the channel-major (MB, 16, KB) rows as a row-major
    (M, 16) copy."""
    ns = load_defs("exp_r5_reduce.py", {"_id_kernel", "force_rowmajor"},
                   M=mb * kb, MB=mb, KB=kb, REC=16)
    ns["pl"] = PL_INTERPRET
    g = np.random.default_rng(mb).standard_normal((mb, 16, kb)).astype(
        np.float32)
    want = np.asarray(ns["force_rowmajor"](
        jnp.asarray(g).transpose(0, 2, 1).reshape(mb * kb, 16)))
    tg = torch.from_numpy(g)
    got = R.row_copy(tg.transpose(1, 2))
    assert got.is_contiguous() and got.shape == (mb * kb, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # a 2-D strided view and a view with a storage offset
    np.testing.assert_array_equal(
        R.row_copy(torch.from_numpy(want.T.copy()).t()).numpy(), want)
    np.testing.assert_array_equal(
        R.row_copy(tg.transpose(1, 2)[1:]).numpy(), want[kb:])


@pytest.mark.parametrize("kernel", ["kernel_take", "kernel_loop"])
def test_row_gather_matches_pallas(kernel):
    import sys
    sys.path.insert(0, TOOLS)
    try:
        import exp_vmem_gather as EG
    finally:
        sys.path.remove(TOOLS)
    n, steps = 700, 16
    rng = np.random.default_rng(1)
    table = rng.random((n, EG.REC)).astype(np.float32)
    idx = rng.integers(0, n, (steps, EG.KB)).astype(np.int32)
    call = pl.pallas_call(
        getattr(EG, kernel), grid=(steps // EG.ROWS,),
        in_specs=[pl.BlockSpec((EG.ROWS, EG.KB), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((n, EG.REC), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((EG.ROWS, EG.KB, EG.REC),
                               lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((steps, EG.KB, EG.REC), jnp.float32),
        interpret=True)
    want = np.asarray(call(jnp.asarray(idx), jnp.asarray(table)))
    got = R.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == (steps, EG.KB, EG.REC)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("unroll", [4, 16])
def test_scatter_add_rows_matches_pallas(unroll):
    mb, kb, n1 = 16, 128, 300
    ns = load_defs("exp_vmem_scatter.py", {"kern"}, MB=mb, KB=kb)
    rng = np.random.default_rng(unroll)
    g = rng.random((mb, kb, 16)).astype(np.float32)
    ranks = rng.integers(0, n1, (mb, kb)).astype(np.int32)
    call = pl.pallas_call(
        functools.partial(ns["kern"], unroll=unroll), grid=(mb,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec((1, kb, 16), lambda b: (b, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((n1, 16), lambda b: (0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, n1, 16), jnp.float32),
                        pltpu.SMEM((8, kb), jnp.int32),
                        pltpu.SemaphoreType.DMA],
        out_shape=jax.ShapeDtypeStruct((n1, 16), jnp.float32),
        interpret=True)
    want = np.asarray(call(jnp.asarray(ranks), jnp.asarray(g)))
    got = R.scatter_add_rows(torch.from_numpy(g), torch.from_numpy(ranks),
                             n1).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_reduce_variants_match_jax_v0():
    m, kb, n1, tiles = 4096, 128, 300, 12
    inp = TR.make_inputs("cpu", m=m, n1=n1, kb=kb, tiles=tiles, seed=2)
    ns = load_defs("exp_r5_reduce.py", {"v0", "boundary_diff"}, M=m,
                   MB=m // kb, KB=kb, REC=16, rank_pad=jnp.asarray(inp.rank),
                   bounds_all=jnp.asarray(inp.bounds_all))
    ref = np.asarray(ns["v0"](jnp.asarray(inp.g)))
    assert ref.shape == (n1 + 1, 16)
    scale = np.abs(ref).max()
    for name, fn in TR.VARIANTS.items():
        got = fn(*inp).numpy()
        want = ref[:, :TR.LIVE] if name == "V1" else ref
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_tool_inputs_match_the_jax_tools():
    """The same draws from numpy.random.default_rng(0) as the JAX tools
    (their module-level code, replayed at a small size)."""
    inp = TR.make_inputs("cpu", m=2048, n1=100, kb=128, tiles=5)
    rng = np.random.default_rng(0)
    bounds = np.sort(rng.choice(2047, 4, replace=False) + 1)
    rank = np.concatenate([np.sort(rng.integers(0, 99, len(r)))
                           for r in np.split(np.arange(2048), bounds)])
    np.testing.assert_array_equal(inp.rank.numpy(), rank)
    np.testing.assert_array_equal(
        inp.g.numpy(), rng.standard_normal((16, 16, 128)).astype(np.float32))
    table, idx = TG.make_inputs("cpu", n=50, steps=4)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(table.numpy(),
                                  rng.random((50, 16)).astype(np.float32))
    np.testing.assert_array_equal(idx.numpy(), rng.integers(0, 50, (4, 128)))
    g, ranks = TS.make_inputs("cpu", m=1024, n1=40)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        g.numpy(), rng.random((8, 128, 16)).astype(np.float32))
    np.testing.assert_array_equal(ranks.numpy().reshape(-1),
                                  rng.integers(0, 40, 1024))


@pytest.mark.parametrize("tool", [TR, TG, TS])
def test_tools_run_on_cpu(tool, capsys):
    """Each tool's main() at the JAX tool's shapes, one timed call."""
    out = tool.main(["--device", "cpu", "--reps", "1"])
    printed = capsys.readouterr().out
    assert "host clock" in printed and "not a device time" in printed
    if tool is TR:
        # the variants' running sums over 393,216 f32 rows part by more
        # than the small layout's: 1e-4 of the largest segment sum
        for k in ("max_abs_v0_v1", "max_abs_v0_v2", "max_abs_v0_v3"):
            assert out[k] <= 1e-4 * out["max_abs_v0"], (k, out)
    elif tool is TG:
        assert out["exact"] and out["rows"] == 65_536
    else:
        assert out["max_abs_err"] <= 1e-5 * out["max_abs_sum"]


def test_wrappers_check_their_inputs():
    t = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="outside"):
        R.row_gather(t, torch.tensor([0, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        R.row_gather(t, torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="16 columns"):
        R.row_copy(torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="outside"):
        R.scatter_add_rows(t, torch.tensor([0, 1, 2, 9], dtype=torch.int32),
                           5)
    with pytest.raises(ValueError, match="float32"):
        R.scatter_add_rows(t.double(), torch.zeros(4, dtype=torch.int32), 5)
