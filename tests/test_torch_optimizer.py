"""The port's functional optimizers (``train/optimizer.py``) against the
JAX package's.

  * AdamW (with and without weight decay, a constant and a scheduled
    learning rate), SGD-momentum and Adafactor (factored and unfactored
    leaves) fed the same 20 gradients, made with numpy from a seed, give
    updates within 1e-6 absolute + 1e-6 relative of the reference's at
    every step (f32 sums in another order), and parameters after the
    steps within the same bound;
  * ``global_norm`` and ``clip_by_global_norm`` agree within 1e-6;
  * the reference's single-device optimizer tests
    (``tests/test_optimizer_dist.py``: convergence on a quadratic, the
    factored Adafactor state, clipping) pass on the port, and the state
    lives on the parameters' device over a list-of-dicts (KAN) and a
    nested-dict (LM) tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)

ATOL = RTOL = 1e-6
STEPS = 20
# a KAN-like list of dicts and an LM-like nested dict, with a scalar,
# vectors, matrices and a stacked 3-D leaf (Adafactor factors the last two
# axes of every leaf with two or more dims)
SHAPES = {"kan": [{"c": (5, 9, 3), "w_b": (5, 3)}, {"c": (3, 9, 4), "w_b": (3, 4)}],
          "lm": {"embed": (16, 8), "blocks": {"w": (2, 8, 6), "b": (6,)},
                 "scale": ()}}


def _tree(shapes, rng):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, rng) for v in shapes]
    return rng.standard_normal(shapes).astype(np.float32)


def _to_torch(tree):
    return topt.tree_map(torch.from_numpy, tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_close(got, want, what):
    """Leaf by leaf, walking both trees by key and index."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), what
        for k in got:
            _assert_close(got[k], want[k], f"{what}/{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close(a, b, f"{what}/{i}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=ATOL, rtol=RTOL, err_msg=what)


OPTS = {
    "adamw": (lambda m: m.adamw(3e-3)),
    "adamw_wd_schedule": (lambda m: m.adamw(
        lambda step: 1e-2 / (1.0 + 0.1 * step), weight_decay=1e-2)),
    "sgdm": (lambda m: m.sgdm(0.05)),
    "adafactor": (lambda m: m.adafactor(0.1)),
}


@pytest.mark.parametrize("tree", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(OPTS))
def test_updates_match_the_reference_over_20_steps(name, tree):
    rng = np.random.default_rng(7)
    p0 = _tree(SHAPES[tree], rng)
    grads = [_tree(SHAPES[tree], rng) for _ in range(STEPS)]
    jo, to = OPTS[name](jopt), OPTS[name](topt)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = _to_torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    for step, g in enumerate(grads):
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(_to_torch(g), ts, tp)
        _assert_close(_np(tu), ju, f"{name} step {step}")
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    _assert_close(_np(tp), jp, f"{name} params")
    assert int(ts["step"]) == int(js["step"]) == STEPS


def test_global_norm_and_clipping_match_the_reference():
    rng = np.random.default_rng(3)
    g = _tree(SHAPES["lm"], rng)
    jn = jopt.global_norm(jax.tree.map(jnp.asarray, g))
    tn = topt.global_norm(_to_torch(g))
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    for max_norm in (0.5, 1e3):  # clipped, and left alone
        jc, jn2 = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                           max_norm)
        tc, tn2 = topt.clip_by_global_norm(_to_torch(g), max_norm)
        _assert_close(_np(tc), jc, f"clip {max_norm}")
        np.testing.assert_allclose(float(tn2), float(jn2), rtol=RTOL)


# ----------------------------------------------------------------------------
# the reference's single-device cases (tests/test_optimizer_dist.py:17-48)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("make", [lambda: topt.adamw(0.1),
                                  lambda: topt.adafactor(0.5),
                                  lambda: topt.sgdm(0.05)])
def test_optimizer_converges_quadratic(make):
    opt = make()
    params = {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.tensor(4.0)}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    l0 = float(loss(params))
    for _ in range(200):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        gw, gb = torch.autograd.grad(loss(p), [p["w"], p["b"]])
        u, state = opt.update({"w": gw, "b": gb}, state, params)
        params = topt.apply_updates(params, u)
    assert float(loss(params)) < 0.01 * l0


def test_adafactor_state_is_factored():
    opt = topt.adafactor(0.1)
    params = {"big": torch.zeros((64, 32)), "vec": torch.zeros((7,))}
    st = opt.init(params)
    assert st["v"]["big"]["vr"].shape == (64,)
    assert st["v"]["big"]["vc"].shape == (32,)
    assert st["v"]["vec"]["v"].shape == (7,)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 20.0) < 1e-4
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-4


@pytest.mark.parametrize("name", sorted(OPTS))
def test_state_lives_on_the_params_device_and_keeps_the_tree(name):
    rng = np.random.default_rng(0)
    for tree in ("kan", "lm"):
        params = _to_torch(_tree(SHAPES[tree], rng))
        opt = OPTS[name](topt)
        state = opt.init(params)
        grads = _to_torch(_tree(SHAPES[tree], rng))
        updates, state = opt.update(grads, state, params)
        assert type(updates) is type(params)
        for leaf in topt.tree_leaves(state):
            assert leaf.device == torch.device("cpu")
            assert leaf.dtype in (torch.float32, torch.int32)
        new = topt.apply_updates(params, updates)
        for a, b in zip(topt.tree_leaves(new), topt.tree_leaves(params)):
            assert a.shape == b.shape and a.dtype == b.dtype
