"""The port's bf16 compute dtype of DeformMLP against flax's
`Dense(dtype=bfloat16)` with the same float32 weights, carried across by
`params_from_flax`, on the CPU; and the dtypes the port refuses.

Tolerances: outputs within 8e-3 of the largest |output| (two bf16 ulps:
each product rounds to bf16 in both, and the frameworks' float32 sums
differ in their last bits, so a rounding can land one ulp apart and carry
through the layers; most outputs agree bit for bit); gradients of the
float32 parameters within 3e-2 of the largest entry (the backward's bf16
products round the cotangents as well).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu_torch.models.deform import fields as F
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

CASES = [("baseline", True, False), ("baseline", False, False),
         ("warp", True, False), ("baseline", True, True)]


def _flat(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _pair(kind, is_blender, is_6dof, W=256):
    kw = dict(kind=kind, is_blender=is_blender, is_6dof=is_6dof, D=8, W=W,
              compute_dtype="bfloat16")
    dstate, field = create_deform_field(DeformFieldSpec(**kw),
                                        jax.random.PRNGKey(1))
    tfield = F.create_deform_field(F.DeformFieldSpec(**kw), device="cpu")
    tfield.net.load_state_dict(F.params_from_flax(_flat(dstate.params),
                                                  tfield.net))
    return dstate, field, tfield


def _inputs(n=128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32),
            np.float32(rng.random()))


def _rel(got, ref, tol, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), msg
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"{msg}: {err:.3e} of the largest > {tol}"


@pytest.mark.parametrize("kind,is_blender,is_6dof", CASES)
def test_bf16_mlp_matches_flax(kind, is_blender, is_6dof):
    dstate, field, tfield = _pair(kind, is_blender, is_6dof)
    x, t = _inputs()
    ref = field.step(dstate.params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tfield.step(torch.from_numpy(x), float(t))
    for a, b in zip(got, ref):
        if isinstance(b, float):
            assert a == b == 0.0
            continue
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        _rel(a.numpy(), b, 8e-3)
    # the parameters stay float32
    assert all(p.dtype == torch.float32 for p in tfield.net.parameters())


@pytest.mark.parametrize("kind", ["baseline", "warp"])
def test_bf16_mlp_gradients_match_flax(kind):
    dstate, field, tfield = _pair(kind, True, False, W=64)
    x, t = _inputs(n=64, seed=1)
    cot = np.random.default_rng(2).normal(size=(64, 10)).astype(np.float32)

    def loss(params):
        dx, dr, ds = field.step(params, jnp.asarray(x), jnp.asarray(t))
        out = dx if kind == "warp" else jnp.concatenate([dx, dr, ds], -1)
        return jnp.sum(out * cot[:, :out.shape[1]])
    ref = F.params_from_flax(_flat(jax.grad(loss)(dstate.params)), tfield.net)
    dx, dr, ds = tfield.step(torch.from_numpy(x), float(t))
    out = dx if kind == "warp" else torch.cat([dx, dr, ds], -1)
    total = (out * torch.from_numpy(cot[:, :out.shape[1]])).sum()
    grads = torch.autograd.grad(total, list(tfield.net.parameters()))
    for (name, _), g in zip(tfield.net.named_parameters(), grads):
        assert g.dtype == torch.float32
        _rel(g.numpy(), ref[name].numpy(), 3e-2, name)


@pytest.mark.parametrize("kind", ["ode", "simple", "simple_start"])
def test_bf16_raises_for_the_ode_kinds(kind):
    """The JAX package ignores the dtype of the ODE nets; the port raises."""
    with pytest.raises(ValueError, match="MLP kinds"):
        F.create_deform_field(F.DeformFieldSpec(
            kind=kind, compute_dtype="bfloat16"), device="cpu")


@pytest.mark.parametrize("dtype", ["bf16", "float16", "fp32"])
def test_unknown_dtype_strings_raise(dtype):
    """JAX reads any string but "bfloat16" as float32; the port raises."""
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        F.create_deform_field(F.DeformFieldSpec(compute_dtype=dtype),
                              device="cpu")


def test_mlp_dtype_tools_run_on_cpu():
    """`tools/exp_r5_mlp` (MLP time by dtype) and `exp_r5_mlp_quality` (the
    PSNR A/B) at a tiny size, on the host clock."""
    from d3gs_tpu_torch.tools import exp_r5_mlp, exp_r5_mlp_quality
    out = exp_r5_mlp.main(["--device", "cpu", "--reps", "1", "--n", "64"])
    assert set(out["ms"]) == {"float32 fwd", "float32 fwd+bwd",
                              "bfloat16 fwd", "bfloat16 fwd+bwd"}
    assert "host clock" in out["clock"]
    ab = exp_r5_mlp_quality.main(["--device", "cpu", "--iterations", "6",
                                  "--size", "32"])
    assert np.isfinite([ab["float32"], ab["bfloat16"], ab["delta_db"]]).all()
