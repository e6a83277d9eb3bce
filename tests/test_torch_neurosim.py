"""The port's KAN training and evaluation (``core/neurosim.py``) and MLP
baseline (``core/mlp_baseline.py``) against the JAX package's.

  * the gradient of ``_loss_fn`` (autograd through the Cox-de Boor float
    path, ``torch.minimum(torch.clamp(...))`` at the grid edge) equals
    ``jax.grad`` within 1e-5 absolute + 1e-5 relative;
  * ``train_kan`` from carried parameters, fed the reference's epoch
    permutations, ends within 1e-5 (+1e-5 relative) of the reference's
    parameters and validation losses after three epochs;
  * ``evaluate_accuracy`` and ``evaluate_accuracy_cim`` (deterministic
    ``CIMConfig``: IR-drop and the ADC, no noise; natural and KAN-SAM
    placement) agree with the reference's: the rows whose predictions
    differ are counted (the reference's accuracy against the port's
    predictions) and must be near-ties, rows whose port top-2 logit margin
    is below 1e-3;
  * ``mlp_apply`` on carried weights within 1e-5, ``mlp_param_count``,
    each package's own ``train_mlp`` on the co-design task's data within
    0.05, and ``train_mlp`` / ``grid_extension_train`` on the port alone.

Data comes from the knot surrogate (the same arrays in both packages for
one seed); weights move between the packages through numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mlp_baseline as jmlp
from repro.core import neurosim as jns
from repro.core.cim import CIMConfig as JCIMConfig
from repro.core.kan_layer import KANSpec as JKANSpec
from repro.core.kan_layer import init_kan_network as j_init
from repro_torch.convert import params_from_numpy
from repro_torch.core import mlp_baseline as tmlp
from repro_torch.core import neurosim as tns
from repro_torch.core.cim import CIMConfig
from repro_torch.core.kan_layer import KANSpec
from repro_torch.data.knot import make_knot_dataset

torch.set_num_threads(1)

TIE_MARGIN = 1e-3  # top-2 logit margin under which a row counts as a tie


@pytest.fixture(scope="module")
def knot():
    return make_knot_dataset(4096, 1024, seed=0, label_noise=0.04)


def _carried(dims, grid, seed=1):
    """(port spec, reference spec, port params, reference params): one
    reference initialization, copied through numpy."""
    jk = JKANSpec(dims=dims, grid_size=grid)
    jp = j_init(jax.random.PRNGKey(seed), jk)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return KANSpec(dims=dims, grid_size=grid), jk, tp, jp


def _close(a, b, atol, rtol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize("dims,grid", [((17, 1, 14), 5), ((17, 4, 3, 14), 8)])
def test_loss_gradient_matches_jax_grad(knot, dims, grid):
    xt, yt, _, _ = knot
    tk, jk, tp, jp = _carried(dims, grid)
    x, y = xt[:512], yt[:512]
    jl, jg = jax.value_and_grad(jns._loss_fn)(jp, jnp.asarray(x),
                                               jnp.asarray(y), jk)
    leaves = [v.requires_grad_(True) for p in tp for v in p.values()]
    tl = tns._loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y), tk)
    tg = torch.autograd.grad(tl, leaves)
    _close(float(tl), float(jl), 1e-5, 1e-5, "loss")
    want = [g[k] for g in jg for k in ("c", "w_b")]
    assert len(tg) == len(want)
    for li, (a, b) in enumerate(zip(tg, want)):
        _close(a.numpy(), b, 1e-5, 1e-5, f"grad leaf {li}")


def test_train_kan_epochs_match_the_reference_with_its_permutations(knot):
    xt, yt, xv, yv = knot
    xt, yt = xt[:2048], yt[:2048]
    tk, jk, tp, jp = _carried((17, 4, 14), 8)
    epochs, seed = 3, 5
    # the reference's permutations: split its key once per epoch
    key, perms = jax.random.PRNGKey(seed), []
    for _ in range(epochs):
        key, sk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sk, xt.shape[0])))
    jp2, jh = jns.train_kan(jk, xt, yt, xv, yv, epochs=epochs, params=jp,
                            seed=seed, lr=1.5e-2)
    tp2, th = tns.train_kan(tk, xt, yt, xv, yv, epochs=epochs, params=tp,
                            lr=1.5e-2, permutations=perms)
    _close(th, jh, 1e-5, 1e-5, "validation losses")
    for li, (a, b) in enumerate(zip(tp2, jp2)):
        for k in ("c", "w_b"):
            _close(a[k].numpy(), b[k], 1e-5, 1e-5, f"layer {li} {k}")


@pytest.fixture(scope="module")
def trained(knot):
    """A (17, 4, 14) G=8 network trained by the port, carried to the
    reference: both packages evaluate the same weights."""
    xt, yt, xv, yv = knot
    tk = KANSpec(dims=(17, 4, 14), grid_size=8)
    tp, _ = tns.train_kan(tk, xt, yt, xv, yv, epochs=40, lr=1.5e-2,
                          device="cpu")
    jp = jax.tree.map(jnp.asarray,
                      [{k: v.numpy() for k, v in p.items()} for p in tp])
    return tk, JKANSpec(dims=(17, 4, 14), grid_size=8), tp, jp


def _near_ties(logits: torch.Tensor) -> int:
    top2 = torch.topk(logits, 2, dim=-1).values
    return int(((top2[:, 0] - top2[:, 1]) < TIE_MARGIN).sum())


def test_evaluate_accuracy_matches_the_reference(knot, trained):
    _, _, xv, yv = knot
    tk, jk, tp, jp = trained
    ta = tns.evaluate_accuracy(tp, xv, yv, tk)
    with torch.no_grad():
        logits = tns.kan_network_apply(tp, torch.from_numpy(xv), tk)
    pred = logits.argmax(-1).numpy()
    differ = round(len(yv) * (1.0 - jns.evaluate_accuracy(jp, xv, pred, jk)))
    assert differ <= _near_ties(logits)
    assert abs(ta - jns.evaluate_accuracy(jp, xv, yv, jk)) * len(yv) \
        <= differ + 1e-6


@pytest.mark.parametrize("rows,adc,sam", [(128, 8, False), (128, 8, True),
                                          (256, 6, False)])
def test_evaluate_accuracy_cim_matches_the_reference(knot, trained, rows,
                                                     adc, sam):
    xt, _, xv, yv = knot
    tk, jk, tp, jp = trained
    cfg = dict(array_rows=rows, adc_bits=adc, ir_gamma=0.06,
               deterministic=True)
    tc, jc = CIMConfig(**cfg), JCIMConfig(**cfg)
    calib = xt[:256]
    logits = tns.cim_network_apply(tp, xv, tk, tc, None, use_sam=sam,
                                   calib_x=calib)
    ta = tns.evaluate_accuracy_cim(tp, xv, yv, tk, tc, use_sam=sam,
                                   calib_x=calib)
    pred = logits.argmax(-1).numpy()
    assert ta == float((pred == yv).mean())
    key = jax.random.PRNGKey(0)  # unused by a deterministic config
    ja = jns.evaluate_accuracy_cim(jp, xv, yv, jk, jc, key, use_sam=sam,
                                   calib_x=calib)
    agree = jns.evaluate_accuracy_cim(jp, xv, pred, jk, jc, key,
                                      use_sam=sam, calib_x=calib)
    differ = round(len(yv) * (1.0 - agree))
    assert differ <= _near_ties(logits), (differ, _near_ties(logits))
    assert abs(ta - ja) * len(yv) <= differ + 1e-6, (ta, ja, differ)


def test_noisy_cim_evaluation_reproduces_under_one_generator(knot, trained):
    _, _, xv, yv = knot
    tk, _, tp, _ = trained
    cfg = CIMConfig(ir_gamma=0.06, sigma_ps_ref=0.05)

    def acc(seed):
        return tns.evaluate_accuracy_cim(
            tp, xv, yv, tk, cfg, torch.Generator().manual_seed(seed))

    assert acc(3) == acc(3)
    with pytest.raises(ValueError, match="Generator"):
        tns.evaluate_accuracy_cim(tp, xv, yv, tk, cfg, None)


# ----------------------------------------------------------------------------
# the MLP baseline and step 2
# ----------------------------------------------------------------------------


def test_mlp_apply_and_param_count_match_the_reference(knot):
    _, _, xv, _ = knot
    jp = jmlp.init_mlp(jax.random.PRNGKey(0))
    tp = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
          for p in jp]
    _close(tmlp.mlp_apply(tp, torch.from_numpy(xv)).numpy(),
           jmlp.mlp_apply(jp, jnp.asarray(xv)), 1e-5, 1e-5, "mlp logits")
    assert tmlp.mlp_param_count() == jmlp.mlp_param_count() == 190274
    g = torch.Generator().manual_seed(0)
    shapes = [tuple(p["w"].shape) for p in tmlp.init_mlp(g, device="cpu")]
    assert shapes == [(17, 420), (420, 420), (420, 14)]


def test_each_package_trains_the_mlp_baseline_to_the_same_accuracy():
    """The MLP baseline on the co-design task's data (8192 / 1024 rows, the
    task's label noise): each package's own initialization and epoch
    order, within 0.05 after 60 epochs (its accuracy has levelled off)."""
    xt, yt, xv, yv = make_knot_dataset(8192, 1024, seed=0, label_noise=0.04)
    _, jh = jmlp.train_mlp(jmlp.init_mlp(jax.random.PRNGKey(0)), xt, yt, xv,
                           yv, epochs=40)
    tp = tmlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    _, th = tmlp.train_mlp(tp, xt, yt, xv, yv, epochs=40)
    assert abs(th[-1] - jh[-1]) <= 0.05, (th[-1], jh[-1])


def test_train_mlp_learns_and_reproduces(knot):
    xt, yt, xv, yv = knot
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    _, h1 = tmlp.train_mlp(params, xt, yt, xv, yv, epochs=20, seed=2)
    _, h2 = tmlp.train_mlp(params, xt, yt, xv, yv, epochs=20, seed=2)
    assert h1 == h2
    assert h1[-1] > 1.0 / 14 + 0.2, h1


def test_grid_extension_train_stays_within_constraints(knot):
    xt, yt, xv, yv = knot
    hc = tns.HardwareConstraints(max_area_mm2=0.02, max_energy_pj=300,
                                 max_latency_ns=900)
    out = tns.grid_extension_train((17, 1, 14), hc, xt[:2048], yt[:2048],
                                   xv, yv, g_init=3, extend_by=2,
                                   epochs_per_round=3, max_rounds=2,
                                   device="cpu")
    assert out["G"] in (3, 5, 7) and out["kspec"].grid_size == out["G"]
    assert tns.check_constraints(out["cost"], hc)
    assert [r["G"] for r in out["log"]][0] == 3
    assert out["params"][0]["c"].shape == (17, out["G"] + 3, 1)
