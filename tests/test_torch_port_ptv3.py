"""The port's Point Transformer V3 (`d3gs_tpu_torch/models/ptv3.py`)
against `d3gs_tpu.models.ptv3` on the CPU, weights carried by
`ptv3_from_flax`: the curves and `grid_pool` exactly (features 1e-6), a
Block with dead rows (the xCPE's zero right neighbour), attention with a
fully dead patch (finite, no NaN in values or gradients), PDNorm plain and
adaptive, the tiny model of tests/test_ptv3.py on all-alive, partly dead
and duplicate-cell clouds (outputs 1e-5 of the largest, input and
parameter gradients 1e-4 of each tensor's largest), the default widths at
N = 512, and training mode's draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.models import ptv3 as J
from d3gs_tpu_torch.models import ptv3 as T
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

TINY = dict(in_channels=6, enc_depths=(1, 1, 1), enc_channels=(8, 16, 32),
            enc_heads=(1, 2, 4), dec_depths=(1, 1), dec_channels=(8, 16),
            dec_heads=(1, 2), patch_size=16, curve_depth=6)
N = 96


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cloud(kind, n=N, seed=0, span=40):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    grid = rng.integers(0, span, (n, 3)).astype(np.int32)
    mask = np.ones(n, np.float32)
    if kind == "partly_dead":
        mask[rng.permutation(n)[:n // 6]] = 0.0
    elif kind == "duplicate_cells":
        # a third of the points share a few voxels, some of them dead
        grid[::3] = grid[1:4][np.arange(len(grid[::3])) % 3]
        mask[-8:] = 0.0
    return feats, grid, mask


def _leaves(shapes, rng):
    """Parameters for `jax.eval_shape`'s tree drawn from numpy (flax's
    init is slow here): scales near 1, other leaves ~ N(0, 1 / fan_in)."""
    def leaf(path, s):
        if "scale" in str(path[-1]):
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = s.shape[0] if len(s.shape) > 1 else 4
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _carry(load, module, tree):
    """A standalone flax module's tree into the port's `module` through
    the carrier's loader; every leaf must be taken."""
    leaves = T._Leaves(tree.get("params", tree))
    load(module, leaves, "")
    assert not leaves.left, sorted(leaves.left)
    return module


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / scale if scale > 0 else np.abs(a).max()


@pytest.fixture(scope="module")
def tiny_params():
    """The tiny model, its parameters and one jitted value-and-gradient
    (the three clouds share its shapes, so it compiles once)."""
    model = J.PointTransformerV3(**TINY)
    f, g, m = _cloud("partly_dead")
    params = _leaves(jax.eval_shape(model.init, jax.random.PRNGKey(0), f, g,
                                    m), np.random.default_rng(11))

    def loss(p, feats, grid, mask, w):
        out = model.apply(p, feats, grid, mask)
        return jnp.sum(out * w), out
    return model, params, jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                      has_aux=True))


@pytest.mark.parametrize("depth", [2, 6, 10])
def test_curves_match_jax(depth):
    rng = np.random.default_rng(depth)
    grid = rng.integers(0, 1 << depth, (500, 3)).astype(np.int32)
    tg = torch.from_numpy(grid)
    np.testing.assert_array_equal(T.z_order_encode(tg, depth).numpy(),
                                  np.asarray(J.z_order_encode(grid, depth)))
    np.testing.assert_array_equal(T.hilbert_encode(tg, depth).numpy(),
                                  np.asarray(J.hilbert_encode(grid, depth)))
    for order in T._ORDERS:
        np.testing.assert_array_equal(
            T.serialize(tg, order, depth).numpy(),
            np.asarray(J.serialize(grid, order, depth)))


@pytest.mark.parametrize("kind", ["all_alive", "partly_dead",
                                  "duplicate_cells"])
def test_grid_pool_matches_jax(kind):
    feats, grid, mask = _cloud(kind, n=200, span=12)
    fj, gj, pj, mj = J.grid_pool(feats, grid,
                                 lambda c: J.z_order_encode(c, 6), mask)
    ft, gt, pt, mt = T.grid_pool(torch.from_numpy(feats),
                                 torch.from_numpy(grid),
                                 lambda c: T.z_order_encode(c, 6),
                                 torch.from_numpy(mask))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.sum() < mask.sum()            # some cells merged
    assert _rel(ft.numpy(), fj) <= 1e-6


def _sort(code_fn, grid, mask):
    si, ii = J._sort_and_inverse(code_fn(grid), mask)
    return np.array(si), np.array(ii)


@pytest.mark.parametrize("kind", ["all_alive", "partly_dead"])
def test_block_matches_jax(kind):
    """One block: xCPE at the end of the alive rows (a zero right
    neighbour when any row is dead), attention, MLP; values and the
    input gradient."""
    feats, grid, mask = _cloud(kind, n=64, span=16)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 16)).astype(np.float32) * mask[:, None]
    si, ii = _sort(lambda g: J.serialize(g, "hilbert", 4), grid, mask)
    blk = J.Block(16, 2, 16)
    params = _leaves(jax.eval_shape(blk.init, jax.random.PRNGKey(1), x, si,
                                    ii, mask), rng)
    w = rng.normal(size=(64, 16)).astype(np.float32)

    def loss_j(xx):
        out = blk.apply(params, xx, si, ii, mask)
        return jnp.sum(out * w), out
    (_, out_j), gx_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(x)
    tb = _carry(T._load_block, T.Block(16, 2, 16), _np_tree(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = tb(xt, torch.from_numpy(si).long(), torch.from_numpy(ii).long(),
               torch.from_numpy(mask))
    (out_t * torch.from_numpy(w)).sum().backward()
    assert _rel(out_t.detach().numpy(), out_j) <= 1e-5
    assert _rel(xt.grad.numpy(), gx_j) <= 1e-4
    assert not np.any(out_t.detach().numpy()[mask == 0])


def test_attention_with_a_fully_dead_patch():
    """30 alive rows of 64, patches of 16: the last two patches hold only
    dead rows, whose softmax is uniform and finite as in flax."""
    rng = np.random.default_rng(2)
    n, c = 64, 8
    mask = np.zeros(n, np.float32)
    mask[rng.permutation(n)[:30]] = 1.0
    x = rng.normal(size=(n, c)).astype(np.float32)
    grid = rng.integers(0, 16, (n, 3)).astype(np.int32)
    si, ii = _sort(lambda g: J.z_order_encode(g, 4), grid, mask)
    att = J.SerializedAttention(c, 2, 16)
    params = _leaves(jax.eval_shape(att.init, jax.random.PRNGKey(3), x, si,
                                    ii, mask), rng)
    out_j = jax.jit(att.apply)(params, x, si, ii, mask)
    ta = T.SerializedAttention(c, 2, 16, torch.Generator().manual_seed(0))
    _carry(T._load_attention, ta, _np_tree(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = ta(xt, torch.from_numpy(si).long(), torch.from_numpy(ii).long(),
               torch.from_numpy(mask))
    out_t.square().sum().backward()
    assert _rel(out_t.detach().numpy(), out_j) <= 1e-5
    assert torch.isfinite(xt.grad).all()
    assert all(torch.isfinite(p.grad).all() for p in ta.parameters())


def test_pdnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(10, 8)).astype(np.float32) * 3 + 1
    m = J.PDNorm(8, conditions=("A", "B"))
    p = _np_tree(m.init(jax.random.PRNGKey(0), x, 0))
    p = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(
        np.float32), p)
    tm = _carry(T._load_norm, T.PDNorm(8, conditions=("A", "B")), p)
    for cond in (0, 1):
        assert _rel(tm(torch.from_numpy(x), cond).detach().numpy(),
                    m.apply(p, x, cond)) <= 1e-6
    ma = J.PDNorm(8, conditions=("A",), adaptive=True, context_channels=4)
    ctx = rng.normal(size=(4,)).astype(np.float32)
    pa = _np_tree(ma.init(jax.random.PRNGKey(1), x, 0, ctx))
    ta = _carry(T._load_norm, T.PDNorm(8, conditions=("A",), adaptive=True,
                                       context_channels=4), pa)
    assert _rel(ta(torch.from_numpy(x), 0, torch.from_numpy(ctx))
                .detach().numpy(), ma.apply(pa, x, 0, ctx)) <= 1e-6
    mp = J.PDNorm(8, decouple=False)
    pp = _np_tree(mp.init(jax.random.PRNGKey(2), x, 0))
    tp = _carry(T._load_norm, T.PDNorm(8, decouple=False), pp)
    assert _rel(tp(torch.from_numpy(x)).detach().numpy(),
                mp.apply(pp, x, 0)) <= 1e-6


def _model_and_grads(value_and_grad, params, feats, grid, mask, w, **cfg):
    """JAX output, its gradients (feats, params) of sum(out * w), and the
    port's of the same."""
    (_, out_j), (gp_j, gf_j) = value_and_grad(params, feats, grid, mask, w)
    tm = T.ptv3_from_flax(_np_tree(params), device="cpu", **cfg)
    ft = torch.from_numpy(feats).requires_grad_(True)
    out_t = tm(ft, torch.from_numpy(grid), torch.from_numpy(mask))
    (out_t * torch.from_numpy(w)).sum().backward()
    # the JAX gradient tree carried into the port's layout, by name
    gj = dict(T.ptv3_from_flax(_np_tree(gp_j), device="cpu", **cfg)
              .named_parameters())
    return out_j, gf_j, out_t, ft.grad, tm, gj


@pytest.mark.parametrize("kind", ["all_alive", "partly_dead",
                                  "duplicate_cells"])
def test_tiny_model_matches_jax(tiny_params, kind):
    _, params, value_and_grad = tiny_params
    feats, grid, mask = _cloud(kind)
    w = np.random.default_rng(5).normal(size=(N, 8)).astype(np.float32)
    out_j, gf_j, out_t, gf_t, tm, gj = _model_and_grads(
        value_and_grad, params, feats, grid, mask, w, **TINY)
    assert _rel(out_t.detach().numpy(), out_j) <= 1e-5
    assert not np.any(out_t.detach().numpy()[mask == 0])
    assert _rel(gf_t.numpy(), gf_j) <= 1e-4
    # each parameter's gradient within 1e-4 of the largest over all of
    # them (some are zero up to rounding: a key bias moves no softmax)
    largest = max(g.detach().abs().max().item() for g in gj.values())
    for name, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        err = (p.grad - gj[name].detach()).abs().max().item()
        assert err <= 1e-4 * largest, (name, err, largest)


def test_pdnorm_model_variant_matches_jax():
    cfg = dict(TINY, enc_depths=(1, 1), enc_channels=(8, 16),
               enc_heads=(1, 2), dec_depths=(1,), dec_channels=(8,),
               dec_heads=(1,), pdnorm_ln=True, pdnorm_conditions=("A", "B"))
    model = J.PointTransformerV3(**cfg)
    feats, grid, mask = _cloud("partly_dead")
    params = _leaves(jax.eval_shape(model.init, jax.random.PRNGKey(0), feats,
                                    grid, mask), np.random.default_rng(4))
    apply = jax.jit(model.apply, static_argnames="condition")
    tm = T.ptv3_from_flax(params, device="cpu", **cfg)
    for cond in (0, 1):
        out_t = tm(torch.from_numpy(feats), torch.from_numpy(grid),
                   torch.from_numpy(mask), condition=cond)
        out_j = apply(params, feats, grid, mask, condition=cond)
        assert _rel(out_t.detach().numpy(), out_j) <= 1e-5


def test_carrier_counts_every_leaf(tiny_params):
    tree = _np_tree(tiny_params[1])["params"]
    # 5 Dense, 5 LayerNorm (embedding, 2 pools, 2 unpools), 5 Blocks
    assert len(tree) == 15 and "Block_4" in tree
    extra = dict(tree, Dense_9={"kernel": np.zeros((2, 2), np.float32),
                                "bias": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="unused"):
        T.ptv3_from_flax(extra, device="cpu", **TINY)
    missing = {k: v for k, v in tree.items() if k != "Block_4"}
    with pytest.raises(ValueError, match="Block_4"):
        T.ptv3_from_flax(missing, device="cpu", **TINY)


def test_default_widths_match_jax_at_512():
    """The default model (14,196,320 parameters at in_channels 6): leaves
    drawn from numpy into `jax.eval_shape`'s tree (flax's init takes
    ~40 s here), 512 points with ~5 % dead rows and shared voxels."""
    model = J.PointTransformerV3()
    n = 512
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    grid = rng.integers(0, 1024, (n, 3)).astype(np.int32)
    grid[::5] = grid[1::5][:len(grid[::5])]
    mask = (rng.random(n) > 0.05).astype(np.float32)
    params = _leaves(jax.eval_shape(model.init, jax.random.PRNGKey(0), feats,
                                    grid, mask), rng)
    tm = T.ptv3_from_flax(params, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == 14_196_320
    with torch.no_grad():
        out_t = tm(torch.from_numpy(feats), torch.from_numpy(grid),
                   torch.from_numpy(mask)).numpy()
    out_j = np.asarray(jax.jit(model.apply)(params, feats, grid, mask))
    assert out_t.shape == (n, 64) and np.isfinite(out_t).all()
    assert _rel(out_t, out_j) <= 1e-5


def test_drop_path_keeps_the_mean():
    dp = T.DropPath(0.3)
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4)
    draws = torch.stack([dp(x, False, gen)[0] for _ in range(4000)])
    assert ((draws == 0) | (draws == torch.tensor(1 / 0.7))).all()
    assert abs(draws.mean().item() - 1.0) < 0.05     # ~5 sigma
    assert torch.equal(dp(x, True, gen), x)


def test_training_orders_are_permutations(monkeypatch):
    """Each stage's four blocks run the four orders once, in an order
    drawn from the generator."""
    cfg = dict(TINY, enc_depths=(4, 4), enc_channels=(8, 16),
               enc_heads=(1, 2), dec_depths=(4,), dec_channels=(8,),
               dec_heads=(1,))
    tm = T.PointTransformerV3(**cfg, device="cpu")
    used = []
    real = T.serialize
    monkeypatch.setattr(T, "serialize",
                        lambda g, o, d: used.append(o) or real(g, o, d))
    feats, grid, mask = (torch.from_numpy(a) for a in _cloud("partly_dead"))
    stages = []
    for seed in range(3):
        used.clear()
        tm(feats, grid, mask, deterministic=False,
           generator=torch.Generator().manual_seed(seed))
        assert len(used) == 12
        for s in range(3):
            assert sorted(used[4 * s:4 * s + 4]) == sorted(T._ORDERS)
        stages.append(tuple(used))
    assert len(set(stages)) > 1
    with pytest.raises(ValueError, match="Generator"):
        tm(feats, grid, mask, deterministic=False)


def test_deterministic_equals_training_without_draws():
    cfg = dict(TINY, drop_path=0.0, shuffle_orders=False)
    tm = T.PointTransformerV3(**cfg, device="cpu")
    feats, grid, mask = (torch.from_numpy(a) for a in _cloud("partly_dead"))
    a = tm(feats, grid, mask)
    b = tm(feats, grid, mask, deterministic=False,
           generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    dropped = T.PointTransformerV3(**dict(TINY, drop_path=0.5),
                                   device="cpu")
    c = dropped(feats, grid, mask, deterministic=False,
                generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(c).all() and not torch.equal(c, dropped(
        feats, grid, mask))


def test_model_defaults_to_the_card():
    """Built on the card unless device="cpu" asks for the CPU; without a
    card the default raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        assert next(T.PointTransformerV3(**TINY).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="cpu"):
            T.PointTransformerV3(**TINY)
    assert not next(T.PointTransformerV3(**TINY, device="cpu")
                    .parameters()).is_cuda
