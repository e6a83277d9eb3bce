"""Training on a mesh: ``TrainLoop(shardings=)``, the sharded train step,
ZeRO-1 moments, the elastic restore, on CPU gloo ranks.

One spawn per mesh shape, (1,1), (2,1), (1,2), (2,2) and (1,4)
(``torch_meshtrain_worker.py`` is the rank body; it imports no JAX).  The
parent draws the reference's initial state and writes it as ``step_0``
with the reference's ``Checkpointer``; every loop, sharded or not,
restores it (each rank keeps its slabs) and trains the smoke
``qwen2.5-14b`` ``kan_variant()`` with remat and two microbatches for 3
steps on the ``lm_data`` stream.  Tolerances, those of
``tests/test_torch_train.py`` (f32 sums in another order):

  * losses within 1e-5, grad norms within 1e-5 (relative);
  * parameters within 1e-5 after the steps, except elements whose
    unsharded gradient fell below 1e-7 at some step (there the sign of an
    Adam step is rounding noise: +-lr for any such gradient), counted and
    under 0.1% of the parameters;
  * at (1,1), and where every data rank runs every row, bit for bit.

Also: the reference's own ``TrainLoop(shardings=)`` at (2,2) on four
forced host devices, on the same checkpoint and stream (its losses
against the port's (2,2) ones); a checkpoint saved at (2,1) and restored
at (1,2); a NaN in one data rank's rows of the loss mask, and an inf that
reaches one data rank's gradients alone; a (1,2) rank's loop built at its
slab size; a batch "data" does not divide;
the MoE (experts cut), recurrent (16 / 1 heads at full width, 4 / 1 here),
patch-prefix (``patch_proj`` cut) and Adafactor (llama3) families at
(1,2); the autograd collectives.
"""

import dataclasses
import filecmp
import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

import torch_meshtrain_worker as W
from repro.configs.registry import smoke_config as j_smoke
from repro.train import checkpoint as JC
from repro.train import train_state as JT
from repro_torch import runtime
from repro_torch.data.lm_data import global_batch_at_step
from repro_torch.models import model as M
from repro_torch.train import checkpoint as TC
from repro_torch.train.loop import batch_to_device
from repro_torch.train.optimizer import tree_leaves, tree_unflatten
from repro_torch.train.train_state import init_state

torch.set_num_threads(1)

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)]
TASKS = {
    (1, 1): ("train",),
    (2, 1): ("train", "nan", "inf_patches", "odd"),
    (1, 2): ("train", "restore", "memory", "families", "collectives"),
    (2, 2): ("train", "nan", "inf_patches", "dry_collectives"),
    (1, 4): ("train",),
}
# (arch, kan_variant): experts cut (mixtral, olmoe), the query heads cut
# and the single KV head whole (recurrentgemma), patch_proj cut (pixtral),
# Adafactor's statistics over cut dims (llama3)
FAMILIES = [("mixtral-8x7b", False), ("olmoe-1b-7b", False),
            ("recurrentgemma-9b", True), ("pixtral-12b", False),
            ("llama3-405b", False)]
DEADLINE_S = 150
LOSS_TOL = 1e-5
GRAD_FLOOR = 1e-7
EXCUSED_SHARE = 1e-3


def _state_like(cfg):
    return init_state(torch.Generator().manual_seed(0), cfg, device="cpu")


def _params_of(leaves, cfg) -> list:
    """The parameters (in checkpoint order) of a whole state's leaves."""
    return TC.flatten(TC.unflatten(_state_like(cfg), leaves)["params"])


def _grad_abs(params, batch, cfg) -> list:
    """|d loss / d params| of the whole batch (checkpoint order)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with runtime.use_attn_backend("ref"):
        loss = M.loss_fn(tree_unflatten(params, leaves),
                         {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return [g.abs() for g in TC.flatten(tree_unflatten(params, grads))]


def _nums(hist) -> list:
    return [(h["loss"], h["grad_norm"]) for h in hist]


def _min_into(acc: list, new: list) -> list:
    return new if not acc else [torch.minimum(a, b) for a, b in
                                zip(acc, new)]


def _close(got: dict, want: dict, cfg, what) -> dict:
    """Losses, grad norms and parameters of a sharded run against the
    unsharded one under the module's tolerances; returns the counts."""
    for a, b in zip(got["hist"], want["hist"]):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL, (what, a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) \
            <= LOSS_TOL * b["grad_norm"], (what, a, b)
    excused = total = 0
    worst = 0.0
    for i, (g, w, gm) in enumerate(zip(_params_of(got["state"], cfg),
                                       _params_of(want["state"], cfg),
                                       want["gmin"])):
        diff = (g - w).abs()
        noisy = gm < GRAD_FLOOR
        excused += int((noisy & (diff > 1e-5)).sum())
        total += diff.numel()
        ok = diff[~noisy]
        worst = max(worst, float(ok.max()) if ok.numel() else 0.0)
        assert worst <= 1e-5, (what, i, worst)
    assert excused <= EXCUSED_SHARE * total, (what, excused, total)
    return {"excused": excused, "total": total, "worst": worst}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's step_0 checkpoint, and the unsharded port's runs."""
    root = tmp_path_factory.mktemp("meshtrain")
    cfg = W.qwen_cfg()
    jcfg = dataclasses.replace(j_smoke("qwen2.5-14b").kan_variant(),
                               remat=True, microbatch=2)
    jst = JT.init_state(jax.random.PRNGKey(0), jcfg)
    step0 = str(root / "step0")
    JC.Checkpointer(step0).save(0, jst, blocking=True)

    # the unsharded port from the same checkpoint and stream, with the
    # smallest |gradient| each element saw
    loop = W.make_loop(cfg, _copy(step0, root / "plain"))
    hist, gmin = [], []
    for step in range(3):
        batch = global_batch_at_step(loop.data_cfg, step)
        gmin = _min_into(gmin, _grad_abs(loop.state["params"], batch, cfg))
        _, m = loop.step_fn(loop.state, batch_to_device(batch, "cpu"))
        hist.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
    plain = {"hist": hist, "state": W.gathered(loop.state), "gmin": gmin,
             "counters": W.counters(loop.state)}
    families = {}
    for arch, kan in FAMILIES:
        fg = []
        run = W.family_run(arch, kan, grads_of=lambda p, b, c: fg.__setitem__(
            slice(None), _min_into(fg, _grad_abs(p, b, c))))
        families[f"{arch}{'-kan' if kan else ''}"] = {**run, "gmin": fg}
    return {"root": root, "step0": step0, "jst": jst, "plain": plain,
            "families": families, "runs": {}}


def _copy(src, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst)


def _spawn(setup, shape) -> list:
    """Run the ranks of one mesh shape once (cached per module)."""
    if shape in setup["runs"]:
        return setup["runs"][shape]
    data, model = shape
    world = data * model
    workdir = setup["root"] / f"mesh{data}x{model}"
    workdir.mkdir()
    inp = {"tasks": TASKS[shape],
           "ckpt": _copy(setup["step0"], workdir / "ck"),
           "ckpt0": _copy(setup["step0"], workdir / "ck0"),
           "poisoned_rows": (3,), "families": FAMILIES,
           "empty": str(workdir / "empty")}
    if shape == (2, 1):
        inp["ckpt_every"] = 3          # saves step_3, sharded
    if shape == (1, 2):
        inp["restore_dir"] = str(setup["root"] / "mesh2x1" / "ck")
        _spawn(setup, (2, 1))
    torch.save(inp, workdir / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.main,
                         args=(r, world, data, model, str(workdir)))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5)
    errs = [(workdir / f).read_text() for f in sorted(os.listdir(workdir))
            if f.startswith("err")]
    assert not hung, f"{len(hung)} ranks still running after {DEADLINE_S} s"
    assert not errs and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs], errs)
    outs = [torch.load(workdir / f"out{r}.pt", weights_only=False)
            for r in range(world)]
    setup["runs"][shape] = outs
    return outs


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_meshed_loop_trains_as_the_unsharded_port(setup, shape):
    outs = _spawn(setup, shape)
    want = setup["plain"]
    cfg = W.qwen_cfg()
    for o in outs:
        got = o["train"]
        assert got["start"] == 0
        assert got["counters"] == want["counters"] == (3, 3, 0)
        # every rank reads the same loss and holds the same whole state
        assert _nums(got["hist"]) == _nums(outs[0]["train"]["hist"])
        for a, b in zip(got["state"], outs[0]["train"]["state"]):
            assert torch.equal(a, b)
    got = outs[0]["train"]
    if shape == (1, 1):
        assert _nums(got["hist"]) == _nums(want["hist"])
        for a, b in zip(got["state"], want["state"]):
            assert torch.equal(a, b)
        assert got["collectives"] == {}
        return
    counts = _close(got, want, cfg, shape)
    coll = got["collectives"]
    # model > 1: heads / FFN / vocabulary reduced and gathered, forward
    # and backward; data > 1: loss and gradients summed, parameters
    # gathered after the ZeRO-1 update
    assert (coll.get("all_reduce", 0) > 0)
    assert (coll.get("all_gather", 0) > 0)
    print(f"mesh {shape}: {counts}; collectives (rank 0, 3 steps) {coll}")


def test_meshed_loop_matches_the_references_sharded_loop(setup):
    """The reference's ``TrainLoop(shardings=)`` at (2,2) on four forced
    host devices (a subprocess, so the device-count flag stays there),
    from the same step_0 and stream: its losses against the port's
    (2,2) losses."""
    ck = _copy(setup["step0"], setup["root"] / "jax2x2")
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import dataclasses, json, jax
        from jax.sharding import PartitionSpec as P
        from repro import runtime as jrt
        from repro.configs.registry import smoke_config
        from repro.data.lm_data import DataConfig
        from repro.dist import sharding as shd
        from repro.launch.mesh import _make_mesh
        from repro.train.loop import TrainLoop
        from repro.train.train_state import init_state

        cfg = dataclasses.replace(smoke_config("qwen2.5-14b").kan_variant(),
                                  remat=True, microbatch=2)
        mesh = _make_mesh((2, 2), ("data", "model"))
        st = jax.eval_shape(lambda: init_state(jax.random.PRNGKey(0), cfg))
        specs = {{"params": shd.param_pspecs(st["params"], mesh),
                  "opt": shd.opt_state_pspecs(st["opt"], st["params"], mesh),
                  "step": P(), "good_steps": P(), "skipped_steps": P()}}
        rows = P("data", None)
        sh = {{"state": shd.to_shardings(specs, mesh),
               "batch": shd.to_shardings({{"tokens": rows, "targets": rows}},
                                         mesh)}}
        d = DataConfig(vocab_size=cfg.vocab_size, seq_len={W.SEQ},
                       global_batch={W.BATCH})
        with jrt.use_attn_backend("ref"):
            loop = TrainLoop(cfg, d, {ck!r}, ckpt_every=100, shardings=sh)
            hist = loop.run(3, log=lambda *_: None)
        print("LOSSES", json.dumps([h["loss"] for h in hist]))
    """)
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
           "HOME": os.environ.get("HOME", ""),
           **{k: v for k, v in os.environ.items() if k.startswith("JAX_")}}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=420, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("LOSSES")]
    ref = json.loads(line[-1].split(" ", 1)[1])
    got = [h["loss"] for h in _spawn(setup, (2, 2))[0]["train"]["hist"]]
    assert len(ref) == len(got) == 3
    for a, b in zip(got, ref):
        assert abs(a - b) <= LOSS_TOL, (got, ref)
    print(f"(2,2) losses: port {got}, reference {ref}")


def test_checkpoint_saved_at_2x1_restores_at_1x2(setup, tmp_path):
    saved = _spawn(setup, (2, 1))[0]["train"]["state"]
    ck = setup["root"] / "mesh2x1" / "ck"
    assert TC.latest_step(str(ck)) == 3
    for o in _spawn(setup, (1, 2)):
        got = o["restore"]
        assert got["start"] == 3
        assert len(got["state"]) == len(saved)
        for a, b in zip(got["state"], saved):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # the files are those an unsharded save of the gathered tree writes
    tree = TC.unflatten(_state_like(W.qwen_cfg()), saved)
    TC.Checkpointer(str(tmp_path)).save(3, tree, blocking=True)
    names = sorted(os.listdir(ck / "step_3"))
    assert names == sorted(os.listdir(tmp_path / "step_3"))
    match, mismatch, errors = filecmp.cmpfiles(
        ck / "step_3", tmp_path / "step_3", names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)
    # and the reference reads them
    jtree = JC.load_pytree(str(ck / "step_3"), setup["jst"])
    for a, b in zip(jax.tree.leaves(jtree), saved):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_nan_in_one_data_ranks_rows_skips_on_every_rank(setup, shape):
    outs = _spawn(setup, shape)
    # row 3 is the second data rank's row of the second microbatch
    assert [o["nan"]["my_rows_finite"] for o in outs] == \
        [r // shape[1] == 0 for r in range(len(outs))]
    for o in outs:
        assert o["nan"]["ok"] is False
        assert o["nan"]["counters"] == (1, 0, 1)
        assert o["nan"]["unchanged"]


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_inf_reaching_one_data_ranks_gradients_skips_on_every_rank(setup,
                                                                    shape):
    """pixtral with +inf in the stub patch embeddings of one data rank's
    row: only that rank's local loss and gradients are non-finite (no
    mask count is shared), so the other ranks skip only because ``ok`` is
    read off the loss and norm summed over "data"."""
    outs = _spawn(setup, shape)
    assert [o["inf_patches"]["my_rows_finite"] for o in outs] == \
        [r // shape[1] == 0 for r in range(len(outs))]
    for o in outs:
        assert o["inf_patches"]["ok"] is False
        assert o["inf_patches"]["counters"] == (1, 0, 1)
        assert o["inf_patches"]["unchanged"]


def test_sharded_loop_is_built_at_its_slab_size(setup, tmp_path):
    """A (1,2) rank makes only its slabs: the bytes its loop's state holds
    are half the unsharded loop's (plus the whole norm scales), and no
    more than 55% of them are ever alive at once while it is built (a
    state drawn whole and then cut would peak at all of them)."""
    plain = W.construction_bytes(None, str(tmp_path))
    assert plain["peak"] >= plain["held"] > 0
    for o in _spawn(setup, (1, 2)):
        got = o["memory"]
        assert 0.5 * plain["held"] <= got["held"] <= 0.52 * plain["held"], (
            got, plain)
        assert got["peak"] <= 0.55 * plain["held"], (got, plain)


def test_batch_that_data_does_not_divide(setup):
    """3 rows on 2 data ranks: every rank runs all 3 and the gradient is
    not summed over "data", so the step is the unsharded one, bit for
    bit (the ZeRO-1 slabs update the same elements)."""
    outs = _spawn(setup, (2, 1))
    loop = W.make_loop(W.qwen_cfg(microbatch=0),
                       _copy(setup["step0"], setup["root"] / "odd"),
                       global_batch=3)
    hist = loop.run(1, log=W.QUIET)
    want = W.gathered(loop.state)
    for o in outs:
        got = o["odd"]
        assert got["rows"] == (None, None)
        assert _nums(got["hist"]) == _nums(hist)
        for a, b in zip(got["state"], want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("family", [f"{a}{'-kan' if k else ''}"
                                    for a, k in FAMILIES])
def test_families_train_under_a_model_axis(setup, family):
    outs = _spawn(setup, (1, 2))
    want = setup["families"][family]
    arch = family.removesuffix("-kan")
    cfg = W.family_cfg(arch, family.endswith("-kan"))
    for o in outs:
        got = o["families"][family]
        assert all(h["ok"] for h in got["hist"])
        counts = _close(got, want, cfg, family)
    assert outs[0]["families"][family]["collectives"].get("all_reduce", 0) > 0
    print(f"{family} at (1,2): {counts}")


def test_dryrun_collectives_equal_the_real_steps(setup):
    """``launch.dryrun`` on a (2,2) ``DryMesh`` at each rank's coordinates
    issues the collectives a real (2,2) gloo step issues there: the same
    counts and bytes, kind by kind."""
    outs = _spawn(setup, (2, 2))
    for o in outs:
        d = o["dry_collectives"]
        assert d["dry"] == d["real"], d
        counts, nbytes = d["real"]
        assert counts.get("all_reduce", 0) > 0
        assert counts.get("all_gather", 0) > 0
        assert set(counts) == set(nbytes) and all(nbytes.values())


def test_autograd_collectives_on_the_model_group(setup):
    outs = _spawn(setup, (1, 2))
    x = torch.arange(6.0).reshape(2, 3)
    for o in outs:
        c = o["collectives"]
        r, n = c["rank"], c["size"]
        same, gx = c["copy"]
        assert same and torch.equal(gx, torch.full_like(x, 3.0))  # 1 + 2
        z, gz = c["reduce"]
        assert torch.equal(z, 3.0 * x)
        assert torch.equal(gz, torch.full_like(x, r + 1.0))  # identity
        w, gw = c["gather"]
        assert torch.equal(w, torch.cat([x, x + 10], dim=-1))
        assert torch.equal(gw, torch.arange(3.0 * n)[3 * r:3 * r + 3]
                           .expand(2, 3))
        # f's backward, g's forward, the gather's forward count; under
        # no_grad f costs nothing and g / gather one each
        assert c["counts"] == {"all_reduce": 2, "all_gather": 1}
        assert c["no_grad_extra"] == {"all_reduce": 1, "all_gather": 1}
