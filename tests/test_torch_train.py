"""The port's LM training (``models.layers._SplineMM``, ``models.model.
loss_fn``, remat, ``train.train_state``, ``train.loop``, ``launch.train``)
against the reference on the same weights.

Weights are drawn by the reference and carried over with
``repro_torch.convert.lm_params_from_numpy``; batches come from the
seekable ``lm_data`` stream (bit-equal in both packages).  Everything runs
in f32 at smoke size.  Tolerances (f32 sums in another order, ``tanh`` of
another library):

  * ``_spline_mm``: dx and dc within 1e-5 * max|ref| + 1e-6 of
    ``jax.vjp`` of the reference's custom VJP;
  * ``loss_fn``: the loss within 1e-5, each gradient leaf within
    1e-4 * max|g_ref| + 1e-6 of ``jax.value_and_grad``;
  * train steps: loss within 1e-5, grad norm within 1e-5 (relative);
    parameters within 1e-5 after 3 steps, except elements whose reference
    gradient fell below 1e-7 at some step: there the sign of an Adam or
    unfactored Adafactor step is rounding noise (its step is
    lr * g / (|g| + eps), +-lr for any g far above eps), so those
    elements are counted, must be under 0.1% of the parameters, and are
    left out;
  * ``TrainLoop`` from a shared ``step_0`` checkpoint: losses within 1e-5.

Within the port the checks are exact: remat on and off give bit-equal
gradients; the NaN guard leaves every parameter and optimizer tensor bit
for bit as it was.
"""

import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs.registry import smoke_config as j_smoke
from repro.data.lm_data import DataConfig as JDataConfig
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import train_state as JT
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro.train.loop import TrainLoop as JTrainLoop
from repro_torch import convert, runtime
from repro_torch.configs import smoke_config
from repro_torch.core.bspline import bspline_basis_fast
from repro_torch.data.lm_data import DataConfig, global_batch_at_step
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import train_state as TT
from repro_torch.train.checkpoint import flatten
from repro_torch.train.loop import TrainLoop
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

torch.set_num_threads(1)

STEPS = 3
GRAD_FLOOR = 1e-7     # below it an Adam step's sign is rounding noise
EXCUSED_SHARE = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(a):
    return torch.from_numpy(np.array(a, copy=True))


def _configs(kan: bool, **kw):
    jcfg, cfg = j_smoke("qwen2.5-14b"), smoke_config("qwen2.5-14b")
    if kan:
        jcfg, cfg = jcfg.kan_variant(), cfg.kan_variant()
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _batch(cfg, step=0, b=4, s=16, mask=False):
    d = DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b)
    batch = global_batch_at_step(d, step)
    if mask:
        rng = np.random.default_rng(step)
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


def _leaf_close(got, want, what, scale=1e-4):
    want = np.asarray(want)
    tol = scale * np.abs(want).max() + 1e-6
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol, (what, err, tol)


# ----------------------------------------------------------------------------
# _spline_mm: the float KAN-FFN's custom VJP
# ----------------------------------------------------------------------------


def _spline_inputs(seed, f=6, o=5, saturate=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 7, f)).astype(np.float32) * 1.5
    if saturate:
        # tanh saturates to the clip edges (z = +-1 exactly in f32), and
        # x = 0 puts z on a knot
        x[0, 0, :3] = (30.0, -30.0, 0.0)
        x[1, 2, :2] = (9.5, -12.0)
    c = rng.normal(size=(f, 11, o)).astype(np.float32) * 0.3
    dy = rng.normal(size=(2, 7, o)).astype(np.float32)
    return x, c, dy


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spline_mm_vjp_matches_reference(seed):
    x, c, dy = _spline_inputs(seed)
    y_ref, vjp = jax.vjp(lambda x_, c_: JL._spline_mm(
        x_, c_, -1.0, (1.0, 8, 3), "kanffn"), jnp.asarray(x), jnp.asarray(c))
    dx_ref, dc_ref = vjp(jnp.asarray(dy))
    xt, ct = _torch(x).requires_grad_(), _torch(c).requires_grad_()
    y = L._SplineMM.apply(xt, ct, -1.0, 1.0, 8, 3)
    dx, dc = torch.autograd.grad(y, (xt, ct), _torch(dy))
    _leaf_close(y.detach(), y_ref, "y", 1e-5)
    _leaf_close(dx, dx_ref, "dx", 1e-5)
    _leaf_close(dc, dc_ref, "dc", 1e-5)
    # saturated inputs: zero gradient, as the reference's clip mask gives
    assert (dx[0, 0, :2] == 0).all() and (dx[1, 2, :2] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spline_mm_forward_keeps_its_bits(dtype):
    """The autograd.Function's forward is the plain forward it replaced
    (serving's float streams do not move)."""
    x, c, _ = _spline_inputs(3)
    xt, ct = _torch(x).to(dtype), _torch(c).to(dtype)
    basis = bspline_basis_fast(torch.tanh(xt.to(torch.float32)), -1.0, 1.0,
                               8, 3)
    b, s, f, nb = basis.shape
    want = (basis.to(dtype).reshape(b * s, f * nb)
            @ ct.reshape(f * nb, -1)).reshape(b, s, -1)
    assert torch.equal(L._SplineMM.apply(xt, ct, -1.0, 1.0, 8, 3), want)


def test_spline_mm_matches_autograd_of_the_plain_forward():
    """Away from the clip edges the custom backward equals autograd
    through the plain forward (the check the card runs at full width)."""
    x, c, dy = _spline_inputs(4, saturate=False)
    xt, ct = _torch(x).requires_grad_(), _torch(c).requires_grad_()
    got = torch.autograd.grad(L._SplineMM.apply(xt, ct, -1.0, 1.0, 8, 3),
                              (xt, ct), _torch(dy))
    basis = bspline_basis_fast(torch.tanh(xt), -1.0, 1.0, 8, 3)
    y = torch.einsum("bsfn,fno->bso", basis, ct)
    want = torch.autograd.grad(y, (xt, ct), _torch(dy))
    for g, w, what in zip(got, want, ("dx", "dc")):
        _leaf_close(g, w.numpy(), what, 1e-5)


# ----------------------------------------------------------------------------
# loss_fn and its gradients; remat
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_weights():
    out = {}
    for kan in (False, True):
        jcfg, cfg = _configs(kan)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        out[kan] = (jcfg, cfg, jp,
                    convert.lm_params_from_numpy(_np(jp), device="cpu"))
    return out


def _port_value_and_grad(params, batch, cfg):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with runtime.use_attn_backend("ref"):
        loss = M.loss_fn(tree_unflatten(params, leaves),
                         {k: _torch(v) for k, v in batch.items()}, cfg)
    return loss.detach(), tree_unflatten(params,
                                         torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("kan", [False, True])
def test_loss_and_gradients_match_reference(lm_weights, kan, mask):
    jcfg, cfg, jp, tp = lm_weights[kan]
    batch = _batch(cfg, step=1, mask=mask)
    with jrt.use_attn_backend("ref"):
        want, jgrads = jax.value_and_grad(JM.loss_fn)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, grads = _port_value_and_grad(tp, batch, cfg)
    assert abs(float(loss) - float(want)) <= 1e-5, (float(loss), float(want))
    got, ref = flatten(grads), jax.tree.leaves(jgrads)
    assert len(got) == len(ref)
    for i, (g, w) in enumerate(zip(got, ref)):
        assert tuple(g.shape) == w.shape
        _leaf_close(g, w, f"leaf {i}")


def test_remat_gives_bit_equal_gradients(lm_weights):
    _, cfg, _, tp = lm_weights[True]
    batch = _batch(cfg, step=2)
    runtime.reset_attn_dispatch_counts()
    out = {}
    for remat in (False, True):
        out[remat] = _port_value_and_grad(
            tp, batch, dataclasses.replace(cfg, remat=remat))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(flatten(out[False][1]), flatten(out[True][1])):
        assert torch.equal(a, b)
    # remat recomputes each block's attention in the backward, on "ref"
    layers = cfg.num_layers
    assert runtime.attn_dispatch_counts() == {"ref": 3 * layers}


def test_training_on_the_flash_backend_raises(lm_weights):
    """Kernel B2 has no backward: a differentiated forward through it
    raises instead of training the projections without attention's
    gradient (on the CPU, where its plain version would differentiate,
    as on the card)."""
    _, cfg, _, tp = lm_weights[False]
    batch = {k: _torch(v) for k, v in _batch(cfg).items()}
    wq = tp["decoder"][0]["l0_attn"]["wq"]
    wq.requires_grad_(True)
    try:
        with runtime.use_attn_backend("flash"), \
                pytest.raises(RuntimeError, match="no backward"):
            M.loss_fn(tp, batch, cfg)
        with torch.no_grad(), runtime.use_attn_backend("flash"):
            M.loss_fn(tp, batch, cfg)   # inference still takes B2
    finally:
        wq.requires_grad_(False)


# ----------------------------------------------------------------------------
# the train step against the reference's jitted step
# ----------------------------------------------------------------------------


def _port_state(np_state, cfg):
    params = convert.lm_params_from_numpy(np_state["params"], device="cpu")
    zero = lambda: torch.zeros((), dtype=torch.int32)  # noqa: E731
    return {"params": params, "opt": TT.make_optimizer(cfg).init(params),
            "step": zero(), "good_steps": zero(), "skipped_steps": zero()}


@pytest.mark.parametrize("mb", [0, 2])
@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgdm"])
def test_train_steps_match_reference(opt, mb):
    jcfg, cfg = _configs(True, optimizer=opt, microbatch=mb)
    jst = JT.init_state(jax.random.PRNGKey(0), jcfg)
    tst = _port_state(_np(jst), cfg)
    jstep, tstep = jax.jit(JT.make_train_step(jcfg)), TT.make_train_step(cfg)
    gmin = None
    for step in range(STEPS):
        batch = _batch(cfg, step=step)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with jrt.use_attn_backend("ref"):
            g = jax.grad(JM.loss_fn)(jst["params"], jb, jcfg)
            jst, jm = jstep(jst, jb)
        ga = [np.abs(np.asarray(a)) for a in jax.tree.leaves(g)]
        gmin = ga if gmin is None else [np.minimum(a, b)
                                        for a, b in zip(gmin, ga)]
        tst, tm = tstep(tst, {k: _torch(v) for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-5 * float(jm["grad_norm"])
        assert bool(tm["ok"]) and bool(jm["ok"])
    for k in ("step", "good_steps", "skipped_steps"):
        assert int(tst[k]) == int(jst[k]), k
    assert int(tst["opt"]["step"]) == int(jst["opt"]["step"]) == STEPS
    excused = total = 0
    for i, (got, want, gm) in enumerate(zip(flatten(tst["params"]),
                                            jax.tree.leaves(jst["params"]),
                                            gmin)):
        diff = np.abs(got.numpy() - np.asarray(want))
        noisy = gm < GRAD_FLOOR
        excused += int((noisy & (diff > 1e-5)).sum())
        total += diff.size
        assert diff[~noisy].max(initial=0.0) <= 1e-5, (i, diff[~noisy].max())
    assert excused <= EXCUSED_SHARE * total, (excused, total)


def test_nan_guard_skips_the_step_in_both_packages():
    jcfg, cfg = _configs(True)
    jst = JT.init_state(jax.random.PRNGKey(0), jcfg)
    jst["params"]["final_norm"]["scale"] = \
        jst["params"]["final_norm"]["scale"].at[0].set(jnp.inf)
    np_before = _np(jst)
    tst = _port_state(np_before, cfg)
    t_before = {k: [t.clone() for t in flatten(tst[k])]
                for k in ("params", "opt")}
    batch = _batch(cfg)
    with jrt.use_attn_backend("ref"):
        jst, jm = jax.jit(JT.make_train_step(jcfg))(
            jst, {k: jnp.asarray(v) for k, v in batch.items()})
    tst, tm = TT.make_train_step(cfg)(
        tst, {k: _torch(v) for k, v in batch.items()})
    for st, m in ((jst, jm), (tst, tm)):
        assert not bool(m["ok"])
        assert (int(st["skipped_steps"]), int(st["good_steps"]),
                int(st["step"])) == (1, 0, 1)
    for k in ("params", "opt"):
        for a, b in zip(jax.tree.leaves(jst[k]),
                        jax.tree.leaves(np_before[k])):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert int(jst["opt"]["step"]) == 0
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for k, before in t_before.items():
        for i, (a, b) in enumerate(zip(flatten(tst[k]), before)):
            assert torch.equal(bits(a), bits(b)), (k, i)


# ----------------------------------------------------------------------------
# the loop: same initial weights through a reference checkpoint; the CLI
# ----------------------------------------------------------------------------


def test_train_loop_matches_reference_from_a_shared_step_0(tmp_path):
    """The reference's init_state written as step_0 by the reference's
    Checkpointer; each package's TrainLoop resumes from it and trains 4
    steps on the same stream."""
    jcfg, cfg = _configs(True, num_layers=2)
    jst = JT.init_state(jax.random.PRNGKey(0), jcfg)
    for d in ("ref", "port"):
        JCheckpointer(str(tmp_path / d)).save(0, jst, blocking=True)
    jd = JDataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    td = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    quiet = lambda *_: None  # noqa: E731
    with jrt.use_attn_backend("ref"):
        jl = JTrainLoop(jcfg, jd, str(tmp_path / "ref"), ckpt_every=100)
        jh = jl.run(4, log=quiet)
    tl = TrainLoop(cfg, td, str(tmp_path / "port"), ckpt_every=100,
                   device="cpu")
    assert tl.start_step == jl.start_step == 0
    th = tl.run(4, log=quiet)
    assert [m["step"] for m in th] == [m["step"] for m in jh] == [0, 1, 2, 3]
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= 1e-5, (a, b)
    assert int(tl.state["good_steps"]) == 4


def test_train_cli_runs_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loop, hist = train_cli.main([
            "--arch", "qwen2.5-14b", "--smoke", "--kan-ffn", "--steps", "3",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2"])
    out = buf.getvalue()
    assert "arch=qwen2.5-14b-kanffn device=cpu start_step=0" in out
    assert "done: loss" in out
    assert [m["step"] for m in hist] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in hist)
    assert loop.cfg.microbatch == 0 and loop.cfg.ffn_kind == "kan"
    assert int(loop.state["good_steps"]) == 3
    assert (tmp_path / "ck" / "step_2").is_dir()


def test_card_checks_run_on_the_cpu():
    """The card's training checks (``train.cardcheck``, run by
    ``chip_smoke.py`` and ``tests/test_torch_gpu.py``) at small widths
    with the CPU as the device, so their code is exercised here."""
    from repro_torch.train import cardcheck as tc

    r = tc.check_spline_mm("cpu", 24, 16, tokens=8)
    assert r["dx_max_abs_err"] <= r["dx_tol"]
    _, cfg = _configs(True, microbatch=2, remat=True)
    r = tc.check_card_vs_cpu("cpu", cfg)
    assert r["param_max_abs_err"] == 0.0 and r["excused"] == 0
    assert len(r["losses"]) == 3
    assert all(v > 0 for v in tc.check_inplace_optimizer("cpu").values())
    r = tc.check_restart("cpu", dataclasses.replace(cfg, dtype="bfloat16"))
    assert r["restarted"] == r["losses"][3:]
    assert "torch.bfloat16" in r["dtypes"]
