"""The port's LM examples (``repro_torch.examples.lm_kan_train`` and
``serve_demo``) against the reference's library calls in the example's
order, at smoke sizes, on weights carried through numpy.

  * lm_kan_train: a few steps, then a restart from the last checkpoint,
    from the reference's initial parameters: every loss within 1e-5 of the
    reference's ``TrainLoop`` run the same way (``test_torch_train.py``'s
    tolerance); each package's checkpoint directory restores in the other's
    ``TrainLoop`` at the same ``start_step``, with the saved parameters bit
    for bit;
  * serve_demo: the reference's parameters after its 30 training steps,
    carried across and served as they are: the float streams equal the
    reference's float engine's and the fused streams its fused engine's,
    token for token, on the twin's prompts; the float-vs-fused ``same``
    count is the reference's; in the scheduler run every stream equals its
    final output.  Those trained streams repeat one token, so the same
    holds on the reference's initial parameters too, whose streams vary.
    The twin's own training steps from the carried initial parameters:
    losses within 1e-5 of the reference's over 3 steps.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs.registry import smoke_config as j_smoke
from repro.data.lm_data import DataConfig as JDataConfig
from repro.data.lm_data import global_batch_at_step as j_batch
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import train_state as JT
from repro.train.loop import TrainLoop as JTrainLoop
from repro.train.optimizer import adamw as j_adamw
from repro.train.optimizer import apply_updates as j_apply_updates
from repro_torch import convert
from repro_torch.data.lm_data import DataConfig
from repro_torch.examples import lm_kan_train, serve_demo
from repro_torch.train.checkpoint import flatten
from repro_torch.train.loop import TrainLoop

torch.set_num_threads(1)
quiet = lambda *_: None  # noqa: E731


# ----------------------------------------------------------------------------
# lm_kan_train
# ----------------------------------------------------------------------------

LM = dict(steps=4, restart_steps=2, ckpt_every=2, seq_len=16, global_batch=4)


def _jcfg():
    """examples/lm_kan_train.py's config."""
    return dataclasses.replace(j_smoke("qwen2.5-14b").kan_variant(grid=8),
                               num_layers=2, learning_rate=3e-3)


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm")
    jcfg = _jcfg()
    jd = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=LM["seq_len"],
                     global_batch=LM["global_batch"])
    with jrt.use_attn_backend("ref"):
        jl = JTrainLoop(jcfg, jd, str(root / "ref"), ckpt_every=2)
        jh = jl.run(LM["steps"], log=quiet)
        jl2 = JTrainLoop(jcfg, jd, str(root / "ref"), ckpt_every=2)
        jh2 = jl2.run(LM["restart_steps"], log=quiet)
    # the reference loop's initial parameters (its seed 0), carried
    jp0 = JT.init_state(jax.random.PRNGKey(0), jcfg)["params"]
    tp0 = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp0),
                                       device="cpu")
    out = lm_kan_train.run(**LM, ckpt_dir=str(root / "port"), lm_params=tp0,
                           device="cpu", log=quiet)
    return root, (jl, jl2, jh, jh2), out


def test_lm_kan_train_losses_match_the_reference(lm_runs):
    _, (jl, jl2, jh, jh2), out = lm_runs
    assert out["start_step"] == jl2.start_step == LM["steps"]
    for got, want in ((out["hist"], jh), (out["hist2"], jh2)):
        assert [m["step"] for m in got] == [m["step"] for m in want]
        for a, b in zip(got, want):
            assert abs(a["loss"] - b["loss"]) <= 1e-5, (a, b)
    assert all(np.isfinite(m["loss"]) for m in out["hist"] + out["hist2"])


def test_lm_kan_train_checkpoints_restore_across_the_packages(lm_runs):
    root, (_, jl2, _, _), out = lm_runs
    cfg, jcfg = out["cfg"], _jcfg()
    last = LM["steps"] + LM["restart_steps"]
    jd = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=LM["seq_len"],
                     global_batch=LM["global_batch"])
    td = DataConfig(vocab_size=cfg.vocab_size, seq_len=LM["seq_len"],
                    global_batch=LM["global_batch"])
    port_saved = out["loops"][1].state["params"]
    ref_saved = jl2.state["params"]
    # the port's directory in the reference's loop
    jfrom_port = JTrainLoop(jcfg, jd, str(root / "port"), ckpt_every=2)
    assert jfrom_port.start_step == out["start_step"] + LM["restart_steps"] \
        == last
    for a, b in zip(jax.tree.leaves(jfrom_port.state["params"]),
                    flatten(port_saved)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the reference's directory in the port's loop
    tfrom_ref = TrainLoop(cfg, td, str(root / "ref"), ckpt_every=2,
                          device="cpu")
    assert tfrom_ref.start_step == last
    for a, b in zip(flatten(tfrom_ref.state["params"]),
                    jax.tree.leaves(ref_saved)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------------------------------------
# serve_demo
# ----------------------------------------------------------------------------

SERVE = dict(n_requests=3, max_new=5, stream_requests=2, stream_max_new=3)


def _j_train(params, jcfg, steps):
    """examples/serve_demo.py's jitted AdamW steps; returns the parameters
    and the losses."""
    dcfg = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=8)
    opt = j_adamw(3e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(JM.loss_fn)(params, batch, jcfg)
        updates, opt_state = opt.update(grads, opt_state, params)
        return j_apply_updates(params, updates), opt_state, loss

    losses = []
    for s in range(steps):
        b = {k: jnp.asarray(v) for k, v in j_batch(dcfg, s).items()}
        params, opt_state, loss = step(params, opt_state, b)
        losses.append(float(loss))
    return params, losses


def _serve_both(jp, jcfg) -> tuple:
    """The twin serving ``jp`` as they are, and the reference's float and
    fused engines on the twin's prompts."""
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    out = serve_demo.run(train_steps=0, lm_params=tp, **SERVE, device="cpu",
                         log=quiet)
    ref = {}
    for name, kw in (("float", {}), ("fused", {"kan_deploy": True})):
        eng = JServeEngine(jp, jcfg, slots=3, max_len=64, **kw)
        reqs = [JRequest(rid=i, prompt=list(p),
                         max_new_tokens=SERVE["max_new"])
                for i, p in enumerate(out["prompts"])]
        ref[name] = {r.rid: list(r.output) for r in eng.run(reqs)}
    return out, ref


@pytest.fixture(scope="module")
def lm_weights():
    jcfg = dataclasses.replace(j_smoke("qwen2.5-14b").kan_variant(grid=8),
                               num_layers=2)
    jp0 = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jp, jlosses = _j_train(jp0, jcfg, 30)
    return jcfg, jp0, jp, jlosses


@pytest.mark.parametrize("weights", ["trained", "initial"])
def test_serve_demo_streams_match_the_reference(lm_weights, weights):
    jcfg, jp0, jp, _ = lm_weights
    out, ref = _serve_both(jp if weights == "trained" else jp0, jcfg)
    assert out["float"] == ref["float"]
    assert out["fused"] == ref["fused"]
    ref_same = sum(ref["fused"][rid] == ref["float"][rid] for rid in ref["float"])
    assert out["same"] == ref_same
    assert out["stream_outputs"] == out["streams"]
    assert sorted(out["streams"]) == list(range(SERVE["stream_requests"]))
    for name in ("float", "fused", "stream"):
        st = out["engines"][name]
        assert st["attn_backend"] == "flash"
        assert st["prefill_calls"] > 0 and st["decode_traces"] > 0
    print(f"{weights}: float {out['float']} fused {out['fused']} "
          f"same {out['same']}")


def test_serve_demo_training_matches_the_reference(lm_weights):
    _, jp0, _, jlosses = lm_weights
    tp0 = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp0),
                                       device="cpu")
    cfg = serve_demo.example_config()
    _, losses = serve_demo.train(tp0, cfg, 3)
    np.testing.assert_allclose(losses, jlosses[:3], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,argv,want", [
    # 20 steps: the first checkpoint, then the restart's 10
    ("lm_kan_train", ["--steps", "20"], "restart resumes at step 20"),
    ("serve_demo", [], "requests decode identical tokens"),
], ids=["lm_kan_train", "serve_demo"])
def test_example_main_runs_on_the_cpu(capsys, monkeypatch, tmp_path, name,
                                      argv, want):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    mod = {"lm_kan_train": lm_kan_train, "serve_demo": serve_demo}[name]
    mod.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert want in text and " on cpu" in text, text[-2000:]
