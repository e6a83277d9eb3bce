"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's, both ways, and the reference's own checkpoint and train-loop
tests on the port.

  * files: the same tree saved by either package gives byte-identical
    ``manifest.json`` and ``leaf_<i>.npy`` files (JAX's leaf order, dict
    keys sorted; bf16 leaves with the reference's ``'<V2'`` header);
  * port -> reference: ``load_pytree`` of the reference gives equal arrays
    (bf16 leaves as the raw 2-byte voids it hands back, equal bits);
  * reference -> port: equal tensors, bf16 leaves back as
    ``torch.bfloat16`` with equal bits, on the device of ``like``;
  * the atomic tmp directory, keep-N, the async save, ``restore_latest``,
    the watchdog and the train loop's restart (smoke config, f32, as the
    reference's test; and bf16, with losses bit-equal to an uninterrupted
    run); restoring under new shardings raises (ROADMAP A10).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as J
from repro_torch.configs import smoke_config
from repro_torch.data.lm_data import DataConfig
from repro_torch.train import checkpoint as T
from repro_torch.train.loop import StepWatchdog, TrainLoop
from repro_torch.train.optimizer import tree_map

torch.set_num_threads(1)


def _np_tree(seed=0):
    """Nested dicts (keys out of sorted order), lists, a tuple, f32, int32
    and bf16 leaves, 0-d and n-d."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "zeta": f32(8, 16),
        "alpha": [{"w": f32(3, 4), "b": f32(4)}, {"w": f32(2, 2), "b": f32(2)}],
        "nested": {"c": np.float32(3.5), "b": np.arange(5, dtype=np.int32),
                   "bf": f32(6, 3)},
        "pair": (np.int32(7), f32(2)),
    }


def _jax_tree(t):
    out = jax.tree.map(jnp.asarray, t)
    out["nested"]["bf"] = out["nested"]["bf"].astype(jnp.bfloat16)
    return out


def _torch_tree(t):
    out = tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), t)
    out["nested"]["bf"] = out["nested"]["bf"].to(torch.bfloat16)
    return out


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def test_files_are_byte_identical_to_the_reference(tmp_path):
    t = _np_tree()
    J.save_pytree(_jax_tree(t), str(tmp_path / "ref"))
    T.save_pytree(_torch_tree(t), str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 1 + len(jax.tree.leaves(_jax_tree(t)))
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "ref" / n).read_bytes(), n


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    t = _np_tree(1)
    T.save_pytree(_torch_tree(t), str(tmp_path / "ck"))
    like = _jax_tree(t)
    got = J.load_pytree(str(tmp_path / "ck"), like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(like)):
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(b)))
    # the reference's own restore of a bf16 leaf: raw 2-byte voids
    assert got["nested"]["bf"].dtype == np.dtype("V2")


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    t = _np_tree(2)
    J.save_pytree(_jax_tree(t), str(tmp_path / "ck"))
    like = _torch_tree(_np_tree(5))
    got = T.load_pytree(str(tmp_path / "ck"), like)
    want = _torch_tree(t)
    assert list(got) == list(like) and list(got["nested"]) == \
        list(like["nested"])
    assert isinstance(got["pair"], tuple)
    flat_got, flat_want = T.flatten(got), T.flatten(want)
    assert len(flat_got) == len(flat_want) == 10
    for a, b in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got["nested"]["bf"].dtype == torch.bfloat16


def test_leaf_order_and_treedef_are_jax_s():
    t = _np_tree()
    jt, tt = _jax_tree(t), _torch_tree(t)
    assert T.treedef_str(tt) == str(jax.tree.structure(jt))
    for a, b in zip(T.flatten(tt), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(b)))
    assert T.unflatten(tt, T.flatten(tt)) == tt


# ----------------------------------------------------------------------------
# the reference's checkpoint tests (tests/test_checkpoint_data.py) on the port
# ----------------------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(5), "c": torch.tensor(3.5)}}


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    p = str(tmp_path / "ckpt")
    T.save_pytree(t, p)
    t2 = T.load_pytree(p, t)
    for a, b in zip(T.flatten(t), T.flatten(t2)):
        assert torch.equal(a, b)


def test_atomic_no_partial_dir_visible(tmp_path):
    """A tmp dir from a crashed writer must not count as a checkpoint."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_5.tmp-1234"))
    assert T.latest_step(d) is None
    ck = T.Checkpointer(d, keep=2)
    ck.save(7, _tree(), blocking=True)
    assert T.latest_step(d) == 7


def test_keep_n_rotation(tmp_path):
    ck = T.Checkpointer(str(tmp_path), keep=2)
    for s in [10, 20, 30, 40]:
        ck.save(s, _tree(s), blocking=True)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [30, 40]


def test_restore_latest_and_async(tmp_path):
    ck = T.Checkpointer(str(tmp_path), keep=3)
    t = _tree(1)
    want = t["a"].clone()
    ck.save(3, t)          # async: the host copy is taken now
    t["a"].add_(1.0)       # a train step updating in place meanwhile
    ck.wait()
    restored, step = ck.restore_latest(t)
    assert step == 3
    assert torch.equal(restored["a"], want)


def test_restore_under_new_shardings_raises(tmp_path):
    """The reference's elastic re-shard on restore: under shardings each
    leaf is this rank's slab of the saved whole leaf (here a one-rank
    mesh's, so the whole leaf), and a slab whose implied whole shape is
    not the saved one raises.  Sharded loops are held across mesh shapes
    in tests/test_torch_meshtrain.py."""
    from repro_torch.dist.sharding import PSpec, to_shardings
    from repro_torch.launch.mesh import make_local_mesh

    ck = T.Checkpointer(str(tmp_path), keep=1)
    t = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.arange(3.0)}
    ck.save(1, t, blocking=True)
    mesh = make_local_mesh(1, 1, device="cpu")
    sh = to_shardings({"w": PSpec("data", "model"), "b": PSpec()}, mesh)
    got, step = ck.restore_latest({"w": torch.zeros(4, 4),
                                   "b": torch.zeros(3)}, shardings=sh)
    assert step == 1 and torch.equal(got["w"], t["w"])
    assert torch.equal(got["b"], t["b"])
    with pytest.raises(ValueError, match="saved shape"):
        ck.restore_latest({"w": torch.zeros(2, 4), "b": torch.zeros(3)},
                          shardings=sh)
    # a sharded save of a one-rank mesh writes the unsharded save's files
    ck2 = T.Checkpointer(str(tmp_path / "s"), keep=1)
    ck2.save(1, t, shardings=sh)
    ck2.wait()
    for name in ("manifest.json", "leaf_0.npy", "leaf_1.npy"):
        assert (tmp_path / "s" / "step_1" / name).read_bytes() == \
            (tmp_path / "step_1" / name).read_bytes()
    cfg = smoke_config("qwen2.5-14b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(ValueError, match="state_pspecs"):
        TrainLoop(cfg, dcfg, str(tmp_path / "l"), device="cpu",
                  shardings={"state": to_shardings(
                      {"params": PSpec()}, mesh)})


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(deadline_factor=2.0)
    for _ in range(10):
        assert not wd.observe(0.1)
    assert wd.observe(0.5)
    assert wd.straggler_steps == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loop_checkpoint_restart(tmp_path, dtype):
    """The reference's restart test (smoke config, 2 layers), in f32 and
    in bf16: the restarted loop resumes at step 3 and its losses equal the
    uninterrupted run's bit for bit."""
    cfg = dataclasses.replace(smoke_config("qwen2.5-14b").kan_variant(),
                              num_layers=2, dtype=dtype)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    quiet = lambda *_: None  # noqa: E731
    loop = TrainLoop(cfg, dcfg, str(tmp_path / "ck"), ckpt_every=3,
                     device="cpu")
    h1 = loop.run(num_steps=5, log_every=100, log=quiet)
    assert len(h1) == 5 and all(np.isfinite(m["loss"]) for m in h1)

    # simulate restart: a new loop resumes from step 3's checkpoint
    loop2 = TrainLoop(cfg, dcfg, str(tmp_path / "ck"), ckpt_every=3,
                      device="cpu")
    assert loop2.start_step == 3
    assert loop2.state["params"]["embed"].dtype == getattr(torch, dtype)
    h2 = loop2.run(num_steps=2, log_every=100, log=quiet)
    assert [m["step"] for m in h2] == [3, 4]
    assert [m["loss"] for m in h2] == [m["loss"] for m in h1[3:]]
