"""Dry-run of the production cells: one rank's step on the meta device.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles every
(arch x shape x mesh) cell for 512 forced host devices and reads the
compiled module.  The port runs the step eagerly on the meta device,
where tensors have shapes and dtypes but no memory, as the program of
rank 0 of a :class:`launch.mesh.DryMesh`:

  1. the production mesh ((16, 16) single-pod, (2, 16, 16) multi-pod),
     with no process group: its collectives are ``dist.comm.DryGroup``
     ones, which send nothing and count their payload;
  2. the rank's slabs of the state on meta (``train_state.init_state(
     mesh=)``, ``models.model.init_params(place=)``), cut by the sharding
     rules of ``dist/sharding.py`` as a real rank cuts them;
  3. the step (train: ``make_train_step(cfg, microbatch_spec=)`` bound to
     the mesh; prefill: ``models.model.prefill``; decode: ``init_cache``,
     then ``decode_step``; attention on the "ref" backend, as the
     reference resolves it off the TPU) under ``launch.op_analysis``,
     which records FLOPs, bytes and the memory high-water mark per op,
     and the collective schedule;
  4. the report: ``op_analysis.analyze_step``'s keys, the cell, and the
     largest state any rank coordinate holds, by shape arithmetic on the
     specs.

It chooses no device and allocates nothing anywhere: it is the one entry
point of the port that needs no card, as the reference's needs no TPU.
One full-width cell takes seconds to minutes of host time.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out reports/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import time
import traceback

import torch

from ..configs.base import ModelConfig
from ..configs.registry import SHAPES, cells, get_config
from ..dist import comm
from ..dist import sharding as shd
from ..models import layers as L
from ..models import model as M
from ..runtime.attention import use_attn_backend
from ..train import train_state as TS
from .mesh import make_production_mesh
from .op_analysis import analyze_step, tensor_bytes

__all__ = ["input_specs", "run_cell", "max_slab_bytes", "main"]

META = torch.device("meta")


def _shape(shape) -> dict:
    """A shape of ``configs.registry.SHAPES`` by name, or such a dict
    (``seq_len``, ``global_batch``, ``kind``) itself."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg: ModelConfig, shape_name) -> dict:
    """Meta tensors for every model input of one cell (the whole batch):
    int32 tokens, and the stub ``enc_embeds`` / ``patch_embeds`` in the
    model's dtype."""
    sh = _shape(shape_name)
    b, s = sh["global_batch"], sh["seq_len"]

    def empty(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=META)

    if sh["kind"] == "train":
        spec = {"tokens": empty((b, s)), "targets": empty((b, s))}
    elif sh["kind"] == "prefill":
        spec = {"tokens": empty((b, s))}
    else:  # decode: one new token against a seq_len KV cache
        spec = {"token": empty((b,)), "pos": empty((b,))}
    f = L.torch_dtype(cfg)
    if cfg.family == "audio" and sh["kind"] != "decode":
        spec["enc_embeds"] = empty((b, cfg.enc_seq, cfg.d_model), f)
    if cfg.family == "vlm" and sh["kind"] != "decode":
        spec["patch_embeds"] = empty((b, cfg.num_patches, cfg.patch_embed_dim),
                                     f)
    return spec


def _slab_bytes(shape, dtype, spec: shd.PSpec, sizes: dict) -> int:
    """The largest slab of a tensor under ``spec`` over every coordinate
    of a mesh of ``sizes``: each cut dim's widest share."""
    n = 1
    for i, d in enumerate(shape):
        names = spec[i] if i < len(spec) else None
        names = (names,) if isinstance(names, str) else (names or ())
        cut = math.prod(sizes.get(a, 1) for a in names)
        n *= -(-d // cut)
    return n * torch.empty((), dtype=dtype, device=META).element_size()


def max_slab_bytes(whole, specs, mesh) -> int:
    """The most bytes any rank coordinate of ``mesh`` holds of the tree
    ``whole`` (whole shapes) laid out by the spec tree ``specs``, by shape
    arithmetic: no run per rank."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    leaves, out = [], []
    shd.map_with_path(lambda _p, t: leaves.append(t), whole)
    shd.map_with_path(lambda _p, s: out.append(s), specs)
    return sum(_slab_bytes(t.shape, t.dtype, s, sizes)
               for t, s in zip(leaves, out))


def _rows(mesh, batch: int):
    """(rows of this rank, whether they are a slab of the batch on
    "data")."""
    on_data = shd.batch_pspec(mesh, batch)[0] is not None
    return (batch // shd.axis_size(mesh, "data") if on_data else batch,
            on_data)


def _local(x: dict, rows: int) -> dict:
    """The rank's first ``rows`` rows of each input (rank 0's slab), each
    a tensor of its own."""
    return {k: v[:rows].contiguous() for k, v in x.items()}


def _train_cell(cfg, shape_name, mesh, keep_ops):
    b = _shape(shape_name)["global_batch"]
    mb = max(1, cfg.microbatch)
    whole = TS.meta_state(cfg)
    specs = TS.state_pspecs(whole, mesh)
    state = TS.init_state(None, cfg, device=META, mesh=mesh)
    mb_spec = shd.to_shardings(TS.microbatch_pspec(mesh, b, mb), mesh)
    batch = {k: v.contiguous() for k, v in TS.local_rows(
        input_specs(cfg, shape_name), mb, mb_spec).items()}
    step = TS.make_train_step(cfg, microbatch_spec=mb_spec)
    report = analyze_step(step, state, batch, devices=mesh.size(),
                          keep_ops=keep_ops)
    report["memory"]["state_bytes"] = tensor_bytes(state)
    report["memory"]["state_bytes_max"] = max_slab_bytes(whole, specs, mesh)
    return report


def _serve_cell(cfg, shape_name, mesh, keep_ops):
    sh = _shape(shape_name)
    b, s = sh["global_batch"], sh["seq_len"]
    cache_len = s + (cfg.num_patches if cfg.family == "vlm" else 0)
    tp = M.param_layout(cfg, mesh)
    params = M.init_params(None, cfg, device=META, place=lambda path, leaf:
                           shd.shard_param(path, leaf, mesh))
    rows, on_data = _rows(mesh, b)
    inputs = _local(input_specs(cfg, shape_name), rows)
    dgroup = mesh.get_group("data") if on_data else None
    # "ref" attention, as the reference's dry-run resolves it on its host
    # devices; B2's plain version walks 32-key tiles, which eager meta
    # execution unrolls (1024 tiles a layer at 32k keys)
    with comm.use_tp(tp), comm.use_row_split(dgroup), \
            use_attn_backend("ref"):
        if sh["kind"] == "prefill":
            report = analyze_step(
                lambda p, x: M.prefill(p, x, cfg, max_len=cache_len),
                params, inputs, devices=mesh.size(), keep_ops=keep_ops)
            cache_bytes = 0
        else:
            cache = M.init_cache(params, cfg, rows, cache_len)
            cache_bytes = tensor_bytes(cache)
            report = analyze_step(
                lambda p, c, t, q: M.decode_step(p, c, t, q, cfg),
                params, cache, inputs["token"], inputs["pos"],
                devices=mesh.size(), keep_ops=keep_ops)
    whole = M.init_params(None, cfg, device=META)
    report["memory"]["state_bytes"] = tensor_bytes(params) + cache_bytes
    # every rank's cache has rank 0's shape: rows split evenly on "data"
    # or not at all, heads as evenly as the layout cuts the weights
    report["memory"]["state_bytes_max"] = max_slab_bytes(
        whole, shd.param_pspecs(whole, mesh), mesh) + cache_bytes
    return report


def run_cell(arch: str, shape_name, mesh, save_ops: str | None = None,
             overrides: dict | None = None) -> dict:
    """One cell's report (``op_analysis.analyze_step``'s keys per device,
    rank 0's program).  ``shape_name``: a name of ``SHAPES`` or such a
    dict; ``overrides``: config fields to replace; ``save_ops``: a path
    for the op records as JSON lines."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    kind = _shape(shape_name)["kind"]
    t0 = time.perf_counter()
    cell = _train_cell if kind == "train" else _serve_cell
    report = cell(cfg, shape_name, mesh, keep_ops=save_ops is not None)
    ops = report.pop("ops", None)
    report.update(arch=arch, shape=shape_name, kind=kind,
                  mesh=list(mesh.shape), mesh_axes=list(mesh.mesh_dim_names),
                  run_s=round(time.perf_counter() - t0, 1))
    if save_ops:
        with open(save_ops, "w") as fh:
            for rec in ops:
                fh.write(json.dumps(rec) + "\n")
    return report


def _fmt(report) -> str:
    r = report["roofline"]
    mem = report.get("memory", {})
    return (
        f"{report['arch']:18s} {report['shape']:12s} mesh={report['mesh']} "
        f"flops/dev={report['flops_per_dev']:.3e} "
        f"peak_mem/dev={mem.get('peak_bytes', 0)/2**30:.2f}GiB "
        f"coll/dev={report['collectives']['total']/2**20:.1f}MiB "
        f"terms(c/m/n)=({r['compute_s']:.4f}/{r['memory_s']:.4f}/"
        f"{r['collective_s']:.4f})s dom={r['dominant']} "
        f"roofline={r['roofline_fraction']:.2f} "
        f"[run {report['run_s']}s]"
    )


def _parse_overrides(text: str) -> dict:
    """``k=v,k=v`` -> dict, ints / floats / bools parsed."""
    overrides = {}
    for kv in text.split(","):
        if not kv:
            continue
        k, v = kv.split("=")
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                v = {"true": True, "false": False}.get(v.lower(), v)
        overrides[k] = v
    return overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--save-ops", action="store_true",
                    help="write each cell's op records to {tag}.ops.jsonl")
    ap.add_argument("--set", default="",
                    help="cfg overrides k=v,k=v (ints/floats/bools parsed)")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.set)

    os.makedirs(args.out, exist_ok=True)
    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for (arch, shape), multi in itertools.product(todo, meshes):
        mesh = make_production_mesh(multi_pod=multi)
        tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
        try:
            ops_path = (os.path.join(args.out, tag + ".ops.jsonl")
                        if args.save_ops else None)
            report = run_cell(arch, shape, mesh, save_ops=ops_path,
                              overrides=overrides)
            print(_fmt(report), flush=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as fh:
                json.dump(report, fh, indent=1)
        except Exception:
            failures += 1
            print(f"FAIL {tag}", flush=True)
            traceback.print_exc()
            with open(os.path.join(args.out, tag + ".FAILED"), "w") as fh:
                fh.write(traceback.format_exc())
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
