"""Mesh serving and the meshed KAN runtime on CPU gloo ranks.

One spawn per mesh shape, (1,1), (2,1), (1,2), (2,2), (1,3) and (1,4), each with
several checks (``torch_mesh_worker.py`` is the rank body; it imports no
JAX).  The parent converts the JAX reference's KAN1 and residual FFN
bundles, computes the reference's unsharded outputs (Pallas interpret
mode), hands the bundles and inputs over in ``inputs.pt`` and joins the
ranks with a deadline.  Per shape:

  * the runtime ("fused" through its plain version, "ref", quiet "acim"),
    meshed through ``mesh=`` and through a ``place_deployed_kan`` bundle,
    against the port's unsharded call on the same rank and the
    reference's unsharded outputs: bit-identical at 1x1 and at (1,3)
    (every layer replicated, with a ``shard_notes`` reason); at data-only
    bit-identical where a row's GEMM bits do not depend on the rows beside
    it (the plain versions' CPU GEMM is counted per case, see
    ``test_data_slab_rows_on_the_cpu_gemm``); model-sharded within the
    parity gate with the excused near-ties counted; every rank returns the
    same arrays;
  * the plumbing (precedence of ``mesh=`` > ``use_mesh`` > placement, plan
    cache entries apart), noisy acim reproducible under one seed with
    replicated layers equal across model ranks, ``compressed_grad_sync``
    against numpy, the compress -> decompress round trip onto the mesh;
  * the smoke ``qwen2.5-14b`` ``kan_variant()`` engine serving exactly the
    unsharded port engine's tokens (contiguous, paged, speculative, at
    (2,2) with "flash", at (1,4) with one query head per rank and the KV
    heads whole, at (1,3) with 6 / 2 heads whose query heads straddle KV
    groups), under data every other family the engine serves (gemma2
    ``kan_variant()``, mixtral, mixtral where the MoE capacity binds,
    olmoe paged, recurrentgemma ``kan_variant()``, mamba2), and under
    model mixtral and olmoe paged (experts cut) and recurrentgemma
    ``kan_variant()`` (4 / 1 heads), mirroring
    ``tests/test_serving.py``,
    ``tests/test_kvpool.py`` and ``tests/test_attention_parity.py``'s mesh
    cases, which skip on a one-device reference run;
  * the scheduler's clock: at (2,1) and (1,2), on the wall clock, a request
    that expires behind busy slots and a future arrival, decided on rank
    0's clock (``MeshClock``), alike on every rank and with the unsharded
    engine's streams, and ``launch.serve --mesh ... --deadline``; at 1x1
    and with no mesh, nothing broadcast and the ManualClock trace as
    before.
"""

import multiprocessing as mp
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from conftest import kan1_bundle
from repro import runtime as jrt
from repro.core.kan_layer import KANSpec as JKANSpec
from repro.core.kan_layer import init_kan_network as j_init
from repro.core.kan_network_deploy import deploy_kan_ffn_stack as j_deploy_ffn
from repro.core.kan_network_deploy import quantize_kan_network as j_quantize
from repro.runtime.executor import _entry_codes as j_entry_codes
from repro_torch import convert, parity
from repro_torch.models import layers as TL

torch.set_num_threads(1)

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 3), (1, 4)]
TASKS = {
    (1, 1): ("plumbing", "acim_noise", "compress", "engine", "one_rank"),
    (2, 1): ("acim_noise", "grad_sync", "engine", "clock"),
    (1, 2): ("acim_noise", "compress", "engine", "clock"),
    (2, 2): ("engine",),
    (1, 3): ("acim_noise", "engine"),
    (1, 4): ("engine",),
}
QWEN = "qwen2.5-14b"
PAGED = {"kv_block_size": 8}
MODES = {
    "contiguous": (QWEN, True, {}),
    "paged": (QWEN, True, {**PAGED, "prefill_chunk": 4}),
    "spec": (QWEN, True, {**PAGED, "spec_decode": 2}),
    "flash": (QWEN, True, {"attn_backend": "flash"}),
    # the other families under data, and under model with their experts,
    # heads and vocabulary cut (recurrent blocks replicate)
    "gemma2": ("gemma2-27b", True, {}),
    "mixtral": ("mixtral-8x7b", False, {}),
    # 4 slots at capacity factor 1: the unsharded engine drops assignments
    # (counted in setup), and each data rank routes its 2 slots as part of
    # the batch of 4, never as a batch of its own
    "mixtral_cap": ("mixtral-8x7b", False,
                    {"slots": 4, "max_new": 8,
                     "cfg": {"moe_capacity_factor": 1.0}}),
    "olmoe_paged": ("olmoe-1b-7b", False, PAGED),
    "recurrentgemma": ("recurrentgemma-9b", True, {}),
    "mamba2": ("mamba2-370m", False, {}),
    # 6 query / 2 KV heads at model 3: each rank's 2 query heads straddle
    # the groups of 3, so it attends with one KV head per query head (the
    # vocabulary made divisible by 3, so the logits are still gathered)
    "straddle": (QWEN, True, {"cfg": {"num_heads": 6, "vocab_size": 258}}),
}
ENGINE_MODES = {
    (1, 1): ("contiguous", "paged"),
    (2, 1): ("contiguous", "paged", "spec", "gemma2", "mixtral",
             "mixtral_cap", "olmoe_paged", "recurrentgemma", "mamba2"),
    (1, 2): ("contiguous", "spec", "mixtral", "olmoe_paged",
             "recurrentgemma"),
    (2, 2): ("flash",),
    (1, 3): ("straddle",),
    # 4 query / 2 KV heads at model 4: one query head per rank, inside
    # one KV group
    (1, 4): ("contiguous",),
}
DEADLINE_S = 150
BATCH = 37


def _ffn_bundle():
    jk = JKANSpec(dims=(64, 128, 64), grid_size=8)
    qparams = j_quantize(j_init(jax.random.PRNGKey(0), jk), jk)
    return j_deploy_ffn(qparams, jk.dims, jk.layer_spec(), batch=8)


def _inputs():
    jdeps = {"kan1": kan1_bundle(batch=8)[2], "ffn": _ffn_bundle()}
    rng = np.random.default_rng(7)
    x = {"kan1": rng.uniform(-1, 1, (BATCH, 17)).astype(np.float32),
         "ffn": (rng.normal(size=(BATCH, 64)) * 0.7).astype(np.float32)}
    grads = {"w": rng.normal(size=(2, 5, 7)).astype(np.float32),
             "b": (rng.normal(size=(2, 3)) * 1e-3).astype(np.float32)}
    errors = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
              for k, v in grads.items()}
    prompts = [rng.integers(3, 256, 6).tolist() for _ in range(3)]
    return jdeps, x, grads, errors, prompts


@pytest.fixture(scope="module")
def setup():
    jdeps, x, grads, errors, prompts = _inputs()
    ref = {}
    for name, jdep in jdeps.items():
        jy, jcodes = jrt.execute(jdep, x[name], backend="pallas",
                                 interpret=True, return_intermediates=True)
        j_entry, j_raw = j_entry_codes(jdep, jax.numpy.asarray(x[name]), None)
        ref[name] = {"y": np.asarray(jy),
                     "codes": [np.asarray(c) for c in jcodes],
                     "entry": np.asarray(j_entry),
                     "raw": None if j_raw is None else np.asarray(j_raw)}
    bundles = {n: convert.deployed_from_reference(d, device="cpu")
               for n, d in jdeps.items()}
    # each mode's streams on the unsharded engine (the port's engine
    # itself equals the reference's: tests/test_torch_serve.py), and the
    # MoE assignments its capacity dropped
    streams, drops = {}, {}
    for mode in sorted({m for ms in ENGINE_MODES.values() for m in ms}):
        streams[mode], drops[mode] = _unsharded_streams(mode, prompts)
    return {"bundles": bundles, "x": x, "grads": grads, "errors": errors,
            "prompts": prompts, "ref": ref, "streams": streams,
            "drops": drops, "runs": {}}


def _unsharded_streams(mode, prompts):
    """``mode``'s streams on the unsharded engine and the number of MoE
    assignments its routing dropped (``pos >= cap``)."""
    route = TL.moe_route
    dropped = []

    def counting(*a, **kw):
        flat_e, flat_g, pos, cap = route(*a, **kw)
        dropped.append(int((pos >= cap).sum()))
        return flat_e, flat_g, pos, cap

    TL.moe_route = counting
    try:
        return W.serve_streams(*MODES[mode], prompts)[1], sum(dropped)
    finally:
        TL.moe_route = route


def _spawn(setup, shape, tmp_path_factory) -> list:
    """Run the ranks of one mesh shape once (cached per module)."""
    if shape in setup["runs"]:
        return setup["runs"][shape]
    data, model = shape
    world = data * model
    workdir = str(tmp_path_factory.mktemp(f"mesh{data}x{model}"))
    torch.save({"bundles": setup["bundles"], "x": setup["x"],
                "grads": setup["grads"], "errors": setup["errors"],
                "prompts": setup["prompts"], "tasks": TASKS[shape],
                "engine_modes": {m: MODES[m]
                                 for m in ENGINE_MODES.get(shape, ())}},
               os.path.join(workdir, "inputs.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.main, args=(r, world, data, model, workdir))
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
    errs = [open(os.path.join(workdir, f)).read()
            for f in sorted(os.listdir(workdir)) if f.startswith("err")]
    assert not hung, f"{len(hung)} ranks still running after {DEADLINE_S} s"
    assert not errs and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs], errs)
    outs = [torch.load(os.path.join(workdir, f"out{r}.pt"),
                       weights_only=False) for r in range(world)]
    setup["runs"][shape] = outs
    return outs


def _equal(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def _gate(setup, name, y, codes) -> dict:
    """The parity gate of the port against the reference's unsharded run."""
    r = setup["ref"][name]
    dep = setup["bundles"][name]
    want = [torch.tensor(c) for c in r["codes"]]
    raw = None if r["raw"] is None else torch.tensor(r["raw"])
    pre = parity.boundary_prerounds(dep, torch.tensor(r["entry"]), raw,
                                    want)
    return parity.compare_runs(codes, want, pre, y, r["y"])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_runtime_on_the_mesh(setup, shape, tmp_path_factory):
    outs = _spawn(setup, shape, tmp_path_factory)
    data, model = shape
    rt0 = outs[0]["runtime"]
    for o in outs[1:]:  # every rank returns the same global arrays
        for k, v in o["runtime"].items():
            if k[2] != "plain":
                assert _equal(v, rt0[k]), (k, "differs across ranks")
    excused = {}
    for (name, be, how), (y, codes) in sorted(rt0.items()):
        if how == "plain":
            continue
        plain_y, plain_codes = rt0[(name, be, "plain")]
        assert y.shape == plain_y.shape and y.dtype == torch.float32
        if model == 1 or model == 3:
            # 1x1 and (1,3) run the unsharded launch rows; data-only runs
            # each slab's rows, which the CPU GEMM may sum otherwise
            if data == 1:
                assert _equal([y, codes], [plain_y, plain_codes]), (name, be)
        stats = _gate(setup, name, y, codes)
        excused[(name, be, how)] = stats["excused"]
        assert stats["rows_left_out"] <= 2, (name, be, how, stats)
    print(f"mesh {shape}: excused near-ties {excused}")
    if model == 3:
        assert outs[0]["notes"] and all(
            "columns replicated" in n for n in outs[0]["notes"]), outs[0]
        assert outs[0]["placed_cols/kan1"] == [128, 128]
    elif model == 2:
        assert outs[0]["placed_cols/kan1"] == [64, 64]
        assert outs[0]["notes"] == []


def test_data_slab_rows_on_the_cpu_gemm(setup, tmp_path_factory):
    """Data-only meshes run each rank's slab of rows through the plain
    versions' CPU GEMM; the count of outputs whose bits differ from the
    unsharded call (which runs all rows in one launch) is printed here.
    On the card B1's rows are independent of the rows beside them, and the
    1x1 check there is bit-identical."""
    outs = _spawn(setup, (2, 1), tmp_path_factory)
    rt = outs[0]["runtime"]
    diffs = {}
    for (name, be, how), (y, codes) in sorted(rt.items()):
        if how == "plain":
            continue
        py, pc = rt[(name, be, "plain")]
        diffs[(name, be, how)] = (int((y != py).sum()),
                                  sum(int((a != b).sum())
                                      for a, b in zip(codes, pc)))
    print(f"data=2 outputs / codes differing from the unsharded call: {diffs}")
    assert all(c == 0 for _, c in diffs.values()), diffs


def test_plumbing_precedence_and_cache_keys(setup, tmp_path_factory):
    res = _spawn(setup, (1, 1), tmp_path_factory)[0]["plumbing"]
    for k in ("arg_beats_placement", "placement_alone", "none",
              "replan_keeps_placement", "scope_beats_placement",
              "arg_beats_scope", "none_passes_through"):
        assert res[k], k
    assert res["stats_first"]["entries"] == 2, res
    assert res["stats_first"]["misses"] == 2, res
    assert res["stats_second"]["entries"] == 2, res
    assert res["stats_second"]["hits"] == 2, res


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (1, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_noisy_acim_reproducible_per_shard(setup, shape, tmp_path_factory):
    outs = _spawn(setup, shape, tmp_path_factory)
    for o in outs:
        n = o["acim_noise"]
        assert torch.equal(n["a"], n["b"])
        assert not torch.equal(n["a"], n["c"])
        assert torch.isfinite(n["a"]).all()
        # the gathered output is the same global array on every rank
        assert torch.equal(n["a"], outs[0]["acim_noise"]["a"])


def test_compressed_grad_sync_against_numpy(setup, tmp_path_factory):
    outs = _spawn(setup, (2, 1), tmp_path_factory)
    want_sync, want_ef = {}, {}
    for k, g in setup["grads"].items():
        deqs = []
        for d in range(2):
            ge = g[d] + setup["errors"][k][d]
            q, s = W.reference_quantize(ge)
            deq = q.astype(np.float32) * s
            deqs.append(deq)
            want_ef.setdefault(k, []).append(ge - deq)
        want_sync[k] = (deqs[0] + deqs[1]) / np.float32(2)
    for d, o in enumerate(outs):
        for k in want_sync:
            np.testing.assert_array_equal(o["grad_sync"]["synced"][k].numpy(),
                                          want_sync[k])
            np.testing.assert_array_equal(o["grad_sync"]["new_ef"][k].numpy(),
                                          want_ef[k][d])


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_compress_roundtrip_onto_the_mesh(setup, shape, tmp_path_factory):
    """As ``tests/test_optimizer_dist.py``'s sharded round trip: the gather
    side starts placed, the payload holds the global int8 leaves, the
    decoded bundle lands on the mesh and runs within the codec's error."""
    dep = setup["bundles"]["kan1"]
    for o in _spawn(setup, shape, tmp_path_factory):
        c = o["compress"]
        for entry, lw in zip(c["payload"]["layers"], dep.layers):
            assert entry["wc"][0].dtype == np.int8
            assert entry["wc"][0].shape == tuple(lw["wc"].shape)
        assert c["placed_on_mesh"]
        scale = float(c["y0"].abs().max()) + 1e-6
        assert float((c["y1"] - c["y0"]).abs().max()) < 5e-2 * scale
        assert c["mismatch"] and "does not match" in c["mismatch"]


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2), (1, 3),
                                   (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_engine_serves_the_unsharded_tokens(setup, shape, tmp_path_factory):
    outs = _spawn(setup, shape, tmp_path_factory)
    for o in outs:
        for mode in ENGINE_MODES[shape]:
            assert o["engine"][mode] == setup["streams"][mode], (shape, mode)
            layout = o["engine"][mode + "/layout"]
            assert layout["shape"] == list(shape)
            assert layout["slots_sharded"] == (shape[0] > 1)
            # the collectives the layout implies ran: logits gathered and
            # first tokens broadcast over "data"; heads / vocab reduced and
            # logits and KAN-FFN codes gathered over "model"
            coll = o["engine"][mode + "/collectives"]
            assert (coll.get("broadcast", 0) > 0) == (shape[0] > 1), coll
            assert (coll.get("all_reduce", 0) > 0) == (shape[1] > 1), coll
            assert (coll.get("all_gather", 0) > 0) == (shape != (1, 1)), coll
    if "mixtral_cap" in ENGINE_MODES[shape]:
        assert setup["drops"]["mixtral_cap"] > 0, setup["drops"]
    print(f"engine {shape} collectives (rank 0): "
          f"{ {m: outs[0]['engine'][m + '/collectives'] for m in ENGINE_MODES[shape]} }")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_meshed_scheduler_decides_on_rank0_clock(setup, shape,
                                                 tmp_path_factory):
    """On the wall clock, behind two busy slots: the request with a 1 ms
    deadline expires and the one arriving at 0.05 s is served, alike on
    every rank (statuses, expiry count, completion order, streams), with
    the unsharded engine's streams; the arrival is admitted no earlier
    than its offset on rank 0's clock, and each of the clock's reads is one
    broadcast over the mesh's axis of two ranks."""
    outs = _spawn(setup, shape, tmp_path_factory)
    want = setup["streams"]["contiguous"]
    c0 = outs[0]["clock"]
    for o in outs:
        c = o["clock"]
        assert c["clock"] == "MeshClock"
        assert c["status"] == {0: "done", 1: "done", 2: "expired",
                               3: "done"}, c["status"]
        assert c["expired"] == 1
        for k in ("order", "status", "streams", "expired", "decode_steps",
                  "reads", "now"):
            assert c[k] == c0[k], (k, c[k], c0[k])
        # the arrivals a decision hangs on are rank 0's; the others are
        # each rank's own submission instants
        for rid in (2, 3):
            assert c["arrival_s"][rid] == c0["arrival_s"][rid], rid
        assert c["streams"] == {0: want[0], 1: want[1], 2: [],
                                3: want[2]}, (c["streams"], want)
        assert c["arrival_s"][3] == W.ARRIVAL_S
        assert c["reads"] > 0
        assert c["collectives"].get("broadcast", 0) >= c["reads"]
    assert c0["admitted_s"][3] >= W.ARRIVAL_S, c0["admitted_s"]
    print(f"mesh {shape} clock: {c0['reads']} shared reads over "
          f"{c0['decode_steps']} decode steps, collectives "
          f"{c0['collectives']}")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_meshed_serve_cli_takes_a_deadline(setup, shape, tmp_path_factory):
    """``launch.serve --mesh data=D,model=M --deadline 5`` runs to its end
    on every rank, with the same scheduler line on each."""
    outs = _spawn(setup, shape, tmp_path_factory)
    lines = []
    for o in outs:
        c = o["clock"]
        assert c["cli_return"] is None
        sched = [ln for ln in c["cli_lines"] if "scheduler submitted=" in ln]
        assert sched == ["serve: scheduler submitted=4 completed=4 "
                         "expired=0 rejected=0"], c["cli_lines"]
        assert any(f"data={shape[0]} x model={shape[1]}" in ln
                   for ln in c["cli_lines"]), c["cli_lines"]
        lines.append(sched)
    assert lines[0] == lines[1]


def test_serve_cli_under_torchrun_takes_a_deadline(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh
    data=2 --deadline 5 --device cpu`` exits 0, both ranks serving every
    request (gloo; a hang fails at the join deadline)."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    logs = tmp_path / "logs"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "--log-dir", str(logs), "--redirects",
           "1", "-m", "repro_torch.launch.serve",
           "--arch", "qwen2.5-14b", "--mesh", "data=2", "--deadline", "5",
           "--device", "cpu", "--requests", "4", "--max-new", "4"]
    p = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                       text=True, timeout=DEADLINE_S)
    assert p.returncode == 0, (p.stdout[-4000:], p.stderr[-4000:])
    outs = sorted(logs.rglob("stdout.log"))
    assert len(outs) == 2, outs
    for path in outs:
        lines = [ln for ln in path.read_text().splitlines()
                 if "scheduler submitted=" in ln]
        assert lines == ["serve: scheduler submitted=4 completed=4 "
                         "expired=0 rejected=0"], path.read_text()[-4000:]


# sha256 of the JSONL trace of torch_mesh_worker.one_rank_trace, as the
# scheduler wrote it before it had a mesh clock
ONE_RANK_TRACE_SHA256 = (
    "3af8895bbff8ef35368c8098f7eba0ac2100a88c7576e7b1c9b54593b64d52d9")


def test_one_rank_scheduler_broadcasts_nothing(setup, tmp_path_factory):
    """With no mesh and on a 1x1 mesh the scheduler makes no MeshClock and
    no broadcast: the ManualClock trace hashes as before, and a wall-clock
    deadline and future arrival leave ``dist.comm.COLLECTIVES`` empty."""
    res = _spawn(setup, (1, 1), tmp_path_factory)[0]["one_rank"]
    want = setup["streams"]["contiguous"]
    for name in ("none", "mesh"):
        digest, status, coll = res[name + "/trace"]
        assert digest == ONE_RANK_TRACE_SHA256, name
        assert status == {0: "done", 1: "expired", 2: "done"}, status
        assert coll == {}, (name, coll)
        wall = res[name + "/wall"]
        assert not wall["mesh_clock"], name
        assert wall["collectives"] == {}, (name, wall["collectives"])
        assert wall["status"] == {0: "done", 1: "done", 2: "expired",
                                  3: "done"}, wall["status"]
        assert wall["streams"] == {0: want[0], 1: want[1], 2: [],
                                   3: want[2]}, name
