"""The port's DeformMLP against the flax DeformMLP with the same weights,
carried across by `params_from_flax` and by a JAX-written deform.npz.
Tolerance: rtol 1e-5, with atol 1e-6 for outputs near zero (the two
frameworks sum the 256-wide dot products in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.models.deform.fields import load_deform_weights as jax_load
from d3gs_tpu.models.deform.fields import save_deform_weights as jax_save
from d3gs_tpu_torch.models.deform import fields as F
from d3gs_tpu_torch.models.deform.networks import positional_encoding
from d3gs_tpu.models.deform.networks import positional_encoding as jax_pe


def _flat(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32),
            np.float32(rng.random()))


def _compare(ref, got):
    for a, b in zip(got, ref):
        if isinstance(b, float):
            assert a == b == 0.0
            continue
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,is_blender", [
    ("baseline", True), ("baseline", False), ("warp", True)])
def test_deform_mlp_matches_flax(kind, is_blender):
    spec_kw = dict(kind=kind, is_blender=is_blender, D=8, W=256)
    dstate, field = create_deform_field(DeformFieldSpec(**spec_kw),
                                        jax.random.PRNGKey(1))
    xyz, t = _inputs()
    ref = field.step(dstate.params, jnp.asarray(xyz), jnp.asarray(t))

    tfield = F.create_deform_field(F.DeformFieldSpec(**spec_kw), device="cpu")
    tfield.net.load_state_dict(F.params_from_flax(_flat(dstate.params),
                                                  tfield.net))
    _compare(ref, tfield.step(torch.from_numpy(xyz), float(t)))
    # trunk layer 5 sees [PE(x), t_emb] + the 256 hidden units
    t_dim = 30 if is_blender else 21
    assert tfield.net.trunk[5].in_features == 63 + t_dim + 256


def test_deform_npz_carries_across(tmp_path):
    """A JAX-written deform.npz loads into the port, and the port's own
    save loads back into JAX with the same numbers."""
    spec_kw = dict(kind="baseline", is_blender=True, D=8, W=256)
    dstate, field = create_deform_field(DeformFieldSpec(**spec_kw),
                                        jax.random.PRNGKey(2))
    jax_save(str(tmp_path / "a"), 7, dstate)
    tfield = F.create_deform_field(F.DeformFieldSpec(**spec_kw), seed=5,
                                   device="cpu")
    F.load_deform_weights(str(tmp_path / "a"), tfield)
    xyz, t = _inputs(seed=1)
    ref = field.step(dstate.params, jnp.asarray(xyz), jnp.asarray(t))
    _compare(ref, tfield.step(torch.from_numpy(xyz), float(t)))

    F.save_deform_weights(str(tmp_path / "b"), 3, tfield)
    other, _ = create_deform_field(DeformFieldSpec(**spec_kw),
                                   jax.random.PRNGKey(9))
    back = jax_load(str(tmp_path / "b"), other)
    for k, v in _flat(back.params).items():
        np.testing.assert_array_equal(v, _flat(dstate.params)[k])


def test_positional_encoding():
    x = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(positional_encoding(torch.from_numpy(x),
                                                   10).numpy(),
                               np.asarray(jax_pe(jnp.asarray(x), 10)),
                               rtol=1e-5, atol=1e-6)


def test_unported_kinds_raise():
    """The adaptive solver builds for the ODE kinds and bf16 for the MLP
    kinds; bf16 raises ValueError for the ODE kinds (the JAX package
    ignores it there) and an unknown dtype string raises (JAX reads it as
    float32)."""
    for spec in (F.DeformFieldSpec(kind="ode", solver="adaptive"),
                 F.DeformFieldSpec(kind="simple_start", solver="adaptive"),
                 F.DeformFieldSpec(compute_dtype="bfloat16"),
                 F.DeformFieldSpec(kind="warp", compute_dtype="bfloat16"),
                 F.DeformFieldSpec(kind="ode"),
                 F.DeformFieldSpec(is_6dof=True)):
        assert F.create_deform_field(spec, device="cpu").spec == spec
    for kind in ("ode", "simple", "simple_start"):
        with pytest.raises(ValueError, match="bfloat16"):
            F.create_deform_field(F.DeformFieldSpec(
                kind=kind, compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        F.create_deform_field(F.DeformFieldSpec(compute_dtype="bf16"),
                              device="cpu")
