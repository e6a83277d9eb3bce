"""repro_torch's distribution pieces against the JAX package, no ranks.

  * ``model_shardable`` / ``shard_local_plan`` equal the reference's on
    KAN1, KAN2, the (64, 128, 64) FFN stack and the full-width qwen2.5-14b
    KAN-FFN halves, at model sizes 1-4, notes included;
  * the sharding rules (``param_pspecs`` with and without fsdp,
    ``opt_state_pspecs``, ``batch_pspec``, ``cache_pspecs``,
    ``paged_cache_pspecs``, ``deployed_kan_pspecs``) equal the reference's
    ``PartitionSpec``s entry for entry on the smoke configs of all ten
    archs, on abstract (1, 2), (2, 2) and (2, 4) meshes (the port's rules
    read only axis names and sizes);
  * ``parse_mesh_spec``'s sizes and errors equal the reference's, with the
    device count stubbed on both sides;
  * ``_quantize`` and ``compress_deployed_kan`` of a converted bundle give
    the reference's int8 codes, scales and raw leaves;
  * the port's ``_ref_padded_layer`` (multiply by ``1 / code_step``)
    against the reference's (divide): codes equal except at near-ties,
    which are counted;
  * the pieces that need no process group: ``to_shardings``,
    the split pool's summed stats, ``place_params``' refusals and layout.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kan1_bundle
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import smoke_config as j_smoke
from repro.core.kan_layer import KANSpec as JKANSpec
from repro.core.kan_layer import init_kan_network as j_init
from repro.core.kan_network_deploy import deploy_kan_ffn_stack as j_deploy_ffn
from repro.core.kan_network_deploy import quantize_kan_network as j_quantize
from repro.dist import compress as jcompress
from repro.dist import sharding as jsh
from repro.kernels.kan_spline import pipeline as jpipe
from repro.launch import mesh as jmesh
from repro.models import model as JM
from repro.runtime import executor as jexec
from repro.train.optimizer import adamw as j_adamw
from repro_torch import convert
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.dist import compress as tcompress
from repro_torch.dist import sharding as tsh
from repro_torch.kernels.kan_spline import pipeline as tpipe
from repro_torch.launch.mesh import mesh_spec_sizes
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models.layers import kan_ffn_hidden, kan_ffn_specs
from repro_torch.runtime import executor as texec
from repro_torch.serve.kvpool import KVBlockPool, merged_stats
from repro_torch.train.optimizer import adamw as t_adamw

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 2), (2, 4)]


def _fake_jax_mesh(shape):
    # abstract mesh over CPU devices repeated: only specs are inspected
    # (as tests/test_optimizer_dist.py builds it)
    from jax.sharding import Mesh

    devs = np.array(jax.devices() * (int(np.prod(shape))
                                     // len(jax.devices()) + 1))
    return Mesh(devs[: int(np.prod(shape))].reshape(shape), ("data", "model"))


def _fake_torch_mesh(shape):
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=tuple(shape))


def _jflat(tree) -> dict:
    from jax.sharding import PartitionSpec as P

    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jsh._path_str(kp): tuple(s) for kp, s in flat}


def _tflat(tree) -> dict:
    out = {}
    tsh.map_with_path(lambda p, s: out.__setitem__(p, tuple(s)), tree)
    return out


# ----------------------------------------------------------------------------
# shard_local_plan
# ----------------------------------------------------------------------------


def _plans():
    k1 = JKANSpec(dims=(17, 1, 14), grid_size=5)
    k2 = JKANSpec(dims=(17, 1, 14), grid_size=68)
    ffn = JKANSpec(dims=(64, 128, 64), grid_size=8)
    out = {
        "kan1": (k1.dims, tuple(k1.layer_specs()), False),
        "kan2": (k2.dims, tuple(k2.layer_specs()), False),
        "ffn": (ffn.dims, (ffn.layer_spec(),) * 2, True),
    }
    cfg = get_config("qwen2.5-14b").kan_variant()
    d = cfg.d_model
    out["qwen_full_ffn"] = ((d, kan_ffn_hidden(cfg), d),
                            tuple(kan_ffn_specs(cfg)), True)
    return out


@pytest.mark.parametrize("model_size", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(_plans()))
def test_shard_local_plan_matches_reference(name, model_size):
    dims, specs, raw = _plans()[name]
    if name == "qwen_full_ffn":  # the port's own specs, as the reference's
        from repro.core.asp_quant import ASPQuantSpec as JSpec

        jspecs = tuple(JSpec(**dataclasses.asdict(s)) for s in specs)
        tspecs = specs
    else:
        jspecs = specs
        tspecs = tuple(convert.spec_from_reference(s) for s in specs)
    for batch in (8, 64):
        jplan = jpipe.make_pipeline_plan(batch, dims, jspecs,
                                         residual_raw=raw)
        tplan = tpipe.make_pipeline_plan(batch, dims, tspecs,
                                         residual_raw=raw)
        jl, jf, jn = jpipe.shard_local_plan(jplan, model_size)
        tl, tf, tn = tpipe.shard_local_plan(tplan, model_size)
        assert tf == jf and tn == jn, (tf, jf, tn, jn)
        assert tl.bp == jl.bp
        for a, b in zip(tl.layers, jl.layers):
            assert ((a.f, a.o, a.fp, a.op, a.bb, a.bo, a.bf, a.residual_raw)
                    == (b.f, b.o, b.fp, b.op, b.bb, b.bo, b.bf,
                        b.residual_raw))
        for lp in tplan.layers:
            assert (tpipe.model_shardable(lp.op, model_size)
                    == jpipe.model_shardable(lp.op, model_size))


def test_feature_splits_follow_the_global_layer():
    """A model shard's local ``o`` picks another feature split at some
    widths (gemma2-27b's halves: (10, 8) splits whole, (18, 14) at model 2;
    qwen2.5-14b's keep (20, 5)); the shard body passes the global layer's
    count, and a column slab run at that count equals the same columns of
    the whole layer, bit for bit."""
    cfg = get_config("gemma2-27b").kan_variant()
    d, h = cfg.d_model, kan_ffn_hidden(cfg)
    plan = tpipe.make_pipeline_plan(8, (d, h, d), tuple(kan_ffn_specs(cfg)),
                                    residual_raw=True)
    local, flags, _ = tpipe.shard_local_plan(plan, 2)
    assert all(flags)
    glob = [tpipe.feature_split_plan(lp.f, lp.o)[0] for lp in plan.layers]
    loc = [tpipe.feature_split_plan(lp.f, lp.o)[0] for lp in local.layers]
    assert glob == [10, 8] and loc == [18, 14]
    for lp in plan.layers:  # ceil(f / splits) recovers the planned split
        s, fps = tpipe.feature_split_plan(lp.f, lp.o)
        assert -(-lp.f // s) == fps

    # a small residual layer, 3 feature splits, columns split 2 ways
    from repro_torch.core.asp_quant import ASPQuantSpec

    spec = ASPQuantSpec(grid_size=8, order=3, n_bits=8, lut_bits=8, lo=-1.0,
                        hi=1.0)
    tplan = tpipe.make_pipeline_plan(16, (40, 256), (spec,),
                                     residual_raw=True)
    lp = tplan.layers[0]
    rng = np.random.default_rng(0)
    nb = spec.num_basis
    lw = {"lut": torch.from_numpy(rng.uniform(0, 1, (
              spec.codes_per_interval, spec.order + 1)).astype(np.float32)),
          "wc": torch.from_numpy(rng.normal(size=(lp.fp * nb, lp.op))
                                 .astype(np.float32)),
          "wb": torch.from_numpy(rng.normal(size=(lp.fp, lp.op))
                                 .astype(np.float32))}
    codes = torch.from_numpy(rng.integers(0, spec.num_codes, (16, lp.fp))
                             .astype(np.int32))
    xraw = torch.from_numpy(rng.normal(size=(16, lp.fp)).astype(np.float32))
    whole, _ = tpipe.run_pipeline_layer(codes, xraw, lw, lp, 16,
                                        feature_splits=3)
    llp = tpipe.shard_local_plan(tplan, 2)[0].layers[0]
    for mi in range(2):
        cols = slice(mi * llp.op, (mi + 1) * llp.op)
        slab = {"lut": lw["lut"], "wc": lw["wc"][:, cols].contiguous(),
                "wb": lw["wb"][:, cols].contiguous()}
        part, _ = tpipe.run_pipeline_layer(codes, xraw, slab, llp, 16,
                                           feature_splits=3)
        assert torch.equal(part, whole[:, cols])


# ----------------------------------------------------------------------------
# sharding rules
# ----------------------------------------------------------------------------


def _j_params(arch):
    cfg = j_smoke(arch)
    return cfg, jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                      cfg))


def _t_params(arch):
    cfg = smoke_config(arch)
    return cfg, TM.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_and_opt_state_pspecs_match_reference(arch, shape):
    jcfg, jp = _j_params(arch)
    tcfg, tp = _t_params(arch)
    jm, tm = _fake_jax_mesh(shape), _fake_torch_mesh(shape)
    for fsdp in (False, True):
        want = _jflat(jsh.param_pspecs(jp, jm, fsdp=fsdp))
        got = _tflat(tsh.param_pspecs(tp, tm, fsdp=fsdp))
        assert got == want, {k: (got.get(k), want.get(k))
                             for k in set(got) | set(want)
                             if got.get(k) != want.get(k)}
    jopt = jax.eval_shape(lambda: j_adamw(1e-3).init(jp))
    topt = t_adamw(1e-3).init(tp)
    want = _jflat(jsh.opt_state_pspecs(jopt, jp, jm))
    got = _tflat(tsh.opt_state_pspecs(topt, tp, tm))
    assert got == want
    for b in (1, 2, 4, 6, 8):
        assert tuple(tsh.batch_pspec(tm, b)) == tuple(jsh.batch_pspec(jm, b))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_cache_pspecs_match_reference(arch, shape):
    jcfg, jp = _j_params(arch)
    tcfg, tp = _t_params(arch)
    jm, tm = _fake_jax_mesh(shape), _fake_torch_mesh(shape)
    for batch in (2, 3, 4):
        jc = jax.eval_shape(lambda: JM.init_cache(jp, jcfg, batch, 16))
        tc = TM.init_cache(tp, tcfg, batch, 16)
        assert (_tflat(tsh.cache_pspecs(tc, tm, batch))
                == _jflat(jsh.cache_pspecs(jc, jm, batch)))
    if all(k == "global" for k in tcfg.layer_kinds) and \
            tcfg.encoder_layers == 0 and tcfg.family != "vlm":
        for nb in (4, 5, 9):
            jc = jax.eval_shape(lambda: JM.init_paged_cache(jp, jcfg, nb, 8))
            tc = TM.init_paged_cache(tp, tcfg, nb, 8)
            assert (_tflat(tsh.paged_cache_pspecs(tc, tm, nb))
                    == _jflat(jsh.paged_cache_pspecs(jc, jm, nb)))


def _ffn_jdep():
    jk = JKANSpec(dims=(64, 128, 64), grid_size=8)
    qparams = j_quantize(j_init(jax.random.PRNGKey(0), jk), jk)
    return j_deploy_ffn(qparams, jk.dims, jk.layer_spec(), batch=8)


BUNDLES = {
    "kan1": lambda: kan1_bundle()[2],
    "kan1_mixed_8_4": lambda: kan1_bundle(n_bits=(8, 4))[2],
    "ffn": _ffn_jdep,
}


@pytest.mark.parametrize("model_size", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(BUNDLES))
def test_deployed_kan_pspecs_match_reference(name, model_size):
    jdep = BUNDLES[name]()
    tdep = convert.deployed_from_reference(jdep, device="cpu")
    shape = (1, model_size)
    want = [{k: tuple(v) for k, v in lw.items()}
            for lw in jsh.deployed_kan_pspecs(jdep, _fake_jax_mesh(shape))]
    got = [{k: tuple(v) for k, v in lw.items()}
           for lw in tsh.deployed_kan_pspecs(tdep, _fake_torch_mesh(shape))]
    assert got == want


def test_to_shardings_gives_one_placement_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _fake_torch_mesh((2, 4))
    tree = {"a": tsh.PSpec(None, "model"), "b": [tsh.PSpec(("data",)),
                                                 tsh.PSpec()],
            "c": tsh.PSpec("data", "model")}
    got = tsh.to_shardings(tree, mesh)
    assert got["a"] == (Replicate(), Shard(1))
    assert got["b"][0] == (Shard(0), Replicate())
    assert got["b"][1] == (Replicate(), Replicate())
    assert got["c"] == (Shard(0), Shard(1))


# ----------------------------------------------------------------------------
# parse_mesh_spec
# ----------------------------------------------------------------------------

SPECS = ["data=1,model=1", "data=2,model=4", "data,model=2", "data,model",
         "model", "model=2,data", "", "data=2", "gpu=2", "data=2,data=1",
         "data,data", "data=0", "data=3", "data=16", "data=2,model=2,"]


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_parse_mesh_spec_matches_reference(n_dev, monkeypatch):
    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(n_dev)))
    monkeypatch.setattr(jmesh, "make_local_mesh", lambda d, m: (d, m))
    for spec in SPECS:
        try:
            want = jmesh.parse_mesh_spec(spec)
        except ValueError as e:
            want = f"ValueError: {e}"
        try:
            got = mesh_spec_sizes(spec, n_dev)
        except ValueError as e:
            got = f"ValueError: {e}"
        assert got == want, spec


# ----------------------------------------------------------------------------
# compression
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for g in (rng.normal(size=(33, 17)).astype(np.float32) * 3.7,
              (rng.normal(size=(5,)) * 1e-4).astype(np.float32),
              np.zeros((4,), np.float32)):
        jq, js = jcompress._quantize(jnp.asarray(g))
        tq, ts = tcompress._quantize(torch.from_numpy(g))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tq.dtype == torch.int8
        assert np.float32(ts.item()) == np.float32(js), (ts, js)


@pytest.mark.parametrize("name", sorted(BUNDLES))
def test_compress_payload_matches_reference(name):
    jdep = BUNDLES[name]()
    tdep = convert.deployed_from_reference(jdep, device="cpu")
    want = jcompress.compress_deployed_kan(jdep)
    got = tcompress.compress_deployed_kan(tdep)
    assert got["dims"] == want["dims"]
    assert got["residual_raw"] == want["residual_raw"]
    assert got["specs"] == want["specs"]
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], tuple):
                np.testing.assert_array_equal(g[k][0], w[k][0])
                assert g[k][0].dtype == np.int8
                assert g[k][1] == w[k][1]
            else:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype
    # the unplaced decode equals the reference's decode, leaf for leaf
    back = tcompress.decompress_deployed_kan(got, tdep)
    jback = jcompress.decompress_deployed_kan(want, jdep)
    assert back.placement is None
    for g, w in zip(back.layers, jback.layers):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


# ----------------------------------------------------------------------------
# _ref_padded_layer: multiply against the reference's divide
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(BUNDLES))
def test_ref_padded_layer_matches_reference_up_to_counted_ties(name):
    jdep = BUNDLES[name]()
    tdep = convert.deployed_from_reference(jdep, device="cpu")
    rng = np.random.default_rng(3)
    b = 64
    lp0 = tdep.plan.layers[0]
    tplan = texec.PLAN_CACHE.plan(b, tdep.dims, tdep.specs,
                                  residual_raw=tdep.residual_raw)
    jplan = jpipe.make_pipeline_plan(b, jdep.dims, jdep.specs,
                                     residual_raw=jdep.residual_raw)
    codes = rng.integers(0, lp0.spec.num_codes, (b, lp0.fp)).astype(np.int32)
    codes[:, lp0.f:] = 0
    xraw = (rng.normal(size=(b, lp0.fp)) * 0.7).astype(np.float32)
    xraw[:, lp0.f:] = 0
    ties = flips = 0
    for li, (tlp, jlp) in enumerate(zip(tplan.layers, jplan.layers)):
        raw_t = torch.from_numpy(xraw) if tlp.residual_raw else None
        raw_j = jnp.asarray(xraw) if jlp.residual_raw else None
        ty, tc = texec._ref_padded_layer(tlp, tdep.layers[li],
                                         torch.from_numpy(codes), raw_t)
        jy, jc = jexec._ref_padded_layer(jlp, jdep.layers[li],
                                         jnp.asarray(codes), raw_j)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        if tc is None:
            break
        nxt = tlp.next_spec
        h = (np.tanh(np.asarray(jy, np.float64)) * (0.5 * (nxt.hi - nxt.lo))
             + 0.5 * (nxt.hi + nxt.lo))
        pre = (h - nxt.lo) / nxt.code_step + 0.5
        diff = tc.numpy() != np.asarray(jc)
        near = np.abs(pre - np.round(pre)) < 1e-4
        assert not (diff & ~near).any(), int((diff & ~near).sum())
        assert (np.abs(tc.numpy() - np.asarray(jc))[diff] == 1).all()
        ties += int(near.sum())
        flips += int(diff.sum())
        codes, xraw = tc.numpy(), ty.numpy()
    print(f"{name}: {flips} codes differ, all at near-ties ({ties} near-ties)")


# ----------------------------------------------------------------------------
# pieces that need no process group
# ----------------------------------------------------------------------------


def test_partitioned_pool_shares_and_stats():
    """A data-split pool is one KVBlockPool per data rank (the engine's
    ``pools``): local ids, a prefix cache per share, summed counters."""
    a, b = (KVBlockPool(9, 8) for _ in range(2))
    ids = [a.alloc() for _ in range(3)] + [b.alloc()]
    assert ids == [1, 2, 3, 1]  # local ids, each share with its scratch 0
    a.publish_prefix(list(range(16)), ids[:2])
    assert a.match_prefix(list(range(16)) + [99]) == ids[:2]
    assert b.match_prefix(list(range(16)) + [99]) == []  # per-share cache
    st = merged_stats([a, b])
    assert st["num_blocks"] == 18 and st["shares"] == 2
    assert st["blocks_in_use"] == a.blocks_in_use() + b.blocks_in_use() == 4
    assert st["prefix_hits"] == 2 and st["prefix_misses"] == 2
    assert st["prefix_hit_rate"] == 0.5
    assert merged_stats([a]) == a.stats()  # one pool: its own stats
    a.check_consistent()
    b.check_consistent()


class _RankMesh:
    """A (data, model) mesh at one rank's coordinates, as much of it as
    ``place_params`` reads (no process group: the layout's group is
    None)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coords=(0, 0)):
        self.shape = tuple(shape)
        self._coords = dict(zip(self.mesh_dim_names, coords))

    def get_local_rank(self, name):
        return self._coords[name]

    def get_group(self, name):
        return None

    def __getitem__(self, name):
        return self


def test_place_params_refuses_what_a10b_owns():
    """What ``place_params`` once refused it now cuts: mixtral's experts at
    (1,2) (wi / wg / wo on their hidden dim, the router whole) and qwen's
    4 query / 2 KV heads at (1,4) (one query head per rank, both KV heads
    whole, the one its query head reads attended with)."""
    from repro_torch.dist import comm

    cfg, params = _t_params("mixtral-8x7b")
    placed, tp = TM.place_params(params, cfg, _RankMesh((1, 2), (0, 1)))
    assert (tp.heads, tp.kv, tp.moe, tp.ffn, tp.vocab, tp.size, tp.rank) \
        == (True, True, True, False, True, 2, 1)
    moe, whole = placed["decoder"][0]["l0_moe"], params["decoder"][0]["l0_moe"]
    f = cfg.d_ff // 2
    assert torch.equal(moe["wi"], whole["wi"][..., f:])
    assert torch.equal(moe["wg"], whole["wg"][..., f:])
    assert torch.equal(moe["wo"], whole["wo"][..., f:, :])
    assert torch.equal(moe["router"], whole["router"])
    cfg, params = _t_params("qwen2.5-14b")
    placed, tp = TM.place_params(params, cfg, _RankMesh((1, 4), (0, 3)))
    assert (tp.heads, tp.kv, tp.ffn, tp.vocab, tp.size, tp.rank) \
        == (True, False, True, True, 4, 3)
    attn, whole = placed["decoder"][0]["l0_attn"], params["decoder"][0][
        "l0_attn"]
    assert torch.equal(attn["wq"], whole["wq"][..., 3:4, :])
    assert torch.equal(attn["wo"], whole["wo"][..., 3:4, :, :])
    assert torch.equal(attn["wk"], whole["wk"])
    assert torch.equal(attn["bk"], whole["bk"])
    with comm.use_tp(tp):
        assert L.kv_head_index(cfg, tp) == slice(1, 2)
        assert L.local_kv_heads(cfg) == 1


@pytest.mark.parametrize("hq, hkv, m, want", [
    (4, 2, 2, [slice(0, 1), slice(1, 2)]),          # whole groups
    (4, 1, 2, [slice(0, 1), slice(0, 1)]),          # inside one group
    (16, 1, 2, [slice(0, 1), slice(0, 1)]),         # recurrentgemma-9b
    (32, 8, 16, [slice(r // 2, r // 2 + 1) for r in range(16)]),
    (6, 2, 3, [[0, 0], [0, 1], [1, 1]]),            # straddling
])
def test_kv_head_index_maps_query_heads_to_their_kv_heads(hq, hkv, m, want):
    """Each rank's query heads ``[r Hq/m, (r+1) Hq/m)`` read KV heads
    ``h // G``: a slice where they cover whole groups or fall in one, one
    KV head per query head where they straddle groups (6 / 2 at 3: G = 3,
    two query heads per rank)."""
    from repro_torch.dist.comm import TPLayout

    cfg = dataclasses.replace(smoke_config("qwen2.5-14b"), num_heads=hq,
                              num_kv_heads=hkv)
    g = hq // hkv
    for r in range(m):
        tp = TPLayout(heads=True, size=m, rank=r)
        idx = L.kv_head_index(cfg, tp)
        assert idx == want[r], (r, idx)
        heads = range(hkv)[idx] if isinstance(idx, slice) else idx
        q = range(r * hq // m, (r + 1) * hq // m)
        # the local GQA grouping pairs query head j with local KV head
        # j // (Hq' / Hkv')
        gl = len(q) // len(heads)
        assert [heads[j // gl] for j in range(len(q))] == [h // g for h in q]


@pytest.mark.parametrize("arch, shape, want", [
    ("qwen2.5-14b", (1, 2), {"heads": True, "ffn": True, "vocab": True}),
    ("qwen2.5-14b", (2, 1), {"heads": False, "ffn": False, "vocab": False}),
    # gemma2's tied embedding: the lm head is the vocabulary slab's T
    ("gemma2-27b", (2, 2), {"heads": True, "ffn": True, "vocab": True}),
])
def test_place_params_records_the_cut_roles(arch, shape, want):
    """The layout ``place_params`` returns names the roles it cut, and each
    cut leaf is this rank's slab of the rule's dim."""
    cfg, params = _t_params(arch)
    m = shape[1]
    placed, tp = TM.place_params(params, cfg, _RankMesh(shape, (0, m - 1)))
    assert {r: getattr(tp, r) for r in want} == want
    wq = _leaf(params, "wq")
    got = _leaf(placed, "wq")
    hd = wq.shape[-2] // m
    assert torch.equal(got, wq.narrow(wq.ndim - 2, (m - 1) * hd, hd))
    emb = placed["embed"]
    v = cfg.vocab_size // m
    assert torch.equal(emb, params["embed"][(m - 1) * v:m * v])


def _leaf(tree, key):
    """The first leaf under ``key`` in a param tree."""
    found = []
    tsh.map_with_path(lambda p, leaf: found.append(leaf)
                      if p.rsplit("/", 1)[-1] == key else None, tree)
    return found[0]


def test_meshtrain_card_checks_run_on_the_cpu():
    """The card's model-cut checks (``dist.cardcheck``, run by
    ``chip_smoke.py`` phase 14 and ``tests/test_torch_gpu.py``) at small
    widths on the CPU, so their code is exercised here: a bf16 MoE layer
    of the smoke mixtral and a float KAN-FFN at model 2, and the autograd
    collectives on a world-1 gloo mesh."""
    from repro_torch.dist import cardcheck as dc
    from repro_torch.launch.mesh import make_local_mesh

    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"), dtype="bfloat16")
    r = dc.check_moe_slabs("cpu", cfg, 64)
    assert 0 < r["tol"] == 4 * dc.bf16_ulp(r["max_abs_out"])
    r = dc.check_kan_ffn_slabs("cpu", 64, 32, 16)
    assert set(r["rel_err"]) == {"y", "dx", "c1", "wb1", "c2", "wb2"}
    assert dc.bf16_ulp(1.0) == 2.0 ** -7 and dc.bf16_ulp(6.5) == 2.0 ** -5
    r = dc.check_autograd_collectives(make_local_mesh(1, 1, device="cpu"),
                                      "cpu")
    assert r == {"groups": {"data": 1, "model": 1}}


def test_remat_keeps_the_forwards_layout_on_the_cpu():
    """``dist.cardcheck.check_remat_under_layout`` on a world-1 gloo mesh:
    each slab of the smoke qwen2.5-14b at model 2 (KV heads cut) and 4 (KV
    heads whole) trains alike with remat on and off when the backward runs
    outside the layout's scope."""
    from repro_torch.dist import cardcheck as dc
    from repro_torch.launch.mesh import make_local_mesh

    r = dc.check_remat_under_layout(make_local_mesh(1, 1, device="cpu"),
                                    "cpu")
    assert r == {"layouts": [(2, 0, True, True), (2, 1, True, True)]
                 + [(4, i, True, False) for i in range(4)]}
