"""Fault-tolerant checkpointing: atomic, async, keep-N.

Port of ``repro.train.checkpoint``, with its on-disk layout, so either
package reads the other's checkpoints:

    <dir>/step_<N>/  {manifest.json, leaf_<i>.npy ...}

* **Leaf order** is JAX's flatten order: dict keys sorted, lists and
  tuples in order (not the insertion order ``optimizer.tree_map`` walks).
* **Files**: one ``np.save`` file per leaf.  A bf16 leaf is written as the
  reference writes one (``np.save`` of an ``ml_dtypes.bfloat16`` array):
  header ``'<V2'``, the raw bf16 bits; only the manifest says
  ``"bfloat16"``.  :func:`load_pytree` reads that dtype from the manifest
  and turns ``'<V2'`` back into ``torch.bfloat16`` by bit pattern (the
  reference hands back raw void arrays there).
* **Manifest**: ``{"treedef", "num_leaves", "leaves": [{"i", "shape",
  "dtype"}]}``, ``treedef`` in JAX's ``PyTreeDef(...)`` notation.
* **Atomic**: written to ``step_<N>.tmp-<pid>`` then renamed, so a crash
  mid-write never leaves a readable-but-corrupt checkpoint directory.
* **Async**: tensors are copied to the host synchronously, the file IO
  runs on a daemon thread; ``wait()`` joins before the next save.
* **Keep-N**: the oldest complete checkpoints beyond ``keep`` are deleted.

* **Sharded** (``shardings=``, a tree of ``dist.sharding.MeshSharding``
  from ``to_shardings``, which carries its mesh): a save gathers every
  leaf whole on the caller's thread, at the same step on every rank (a
  collective on the writer thread could deadlock against the next step's),
  one rank writes, and every rank passes a barrier at the next ``wait()``;
  the files are those an unsharded save of the gathered tree writes.  A
  restore reads the files on every rank and keeps this rank's slab of each
  leaf under the NEW shardings, whatever mesh saved them: the reference's
  elastic re-shard.

Leaves are stored whole (unsharded), so a checkpoint is mesh-agnostic.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Checkpointer", "save_pytree", "load_pytree", "gather_pytree",
           "latest_step", "flatten", "flatten_shardings", "unflatten",
           "treedef_str"]

_BF16_DESCR = "<V2"


def flatten(tree) -> list:
    """Leaves of ``tree`` in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in flatten(v)]
    return [tree]


def unflatten(like, leaves: list):
    """``leaves`` (in :func:`flatten` order) in the structure of ``like``."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the caller's key order
        if isinstance(t, (list, tuple)):
            out = [walk(v) for v in t]
            return out if isinstance(t, list) else tuple(out)
        return next(it)

    return walk(like)


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts,
    lists, tuples and leaves."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _host(leaf):
    """(numpy array to write, dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        # a copy even on the CPU: the train step updates its tensors in
        # place while the writer thread reads this one
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _read_leaf(path: str, dtype: str, device) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def _save_host(leaves: list, treedef: str, path: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"treedef": treedef, "num_leaves": len(leaves), "leaves": []}
    for i, (arr, dtype) in enumerate(leaves):
        _write_leaf(os.path.join(tmp, f"leaf_{i}.npy"), arr, dtype)
        manifest["leaves"].append(
            {"i": i, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic publish


def save_pytree(tree, path: str) -> None:
    """Synchronous atomic save of one tree to ``path`` (a directory)."""
    _save_host([_host(l) for l in flatten(tree)], treedef_str(tree), path)


def load_pytree(path: str, like, shardings=None):
    """Restore into the structure of ``like`` (names and order must
    match); each tensor lands on the device of ``like``'s leaf there.

    With ``shardings`` (a tree like ``like`` of ``MeshSharding``s) each
    leaf is this rank's slab of the saved whole leaf; ``like``'s leaves
    then hold slab shapes, and the whole shapes they imply must be the
    saved ones."""
    from ..dist.sharding import global_shape, shard_tensor

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    likes = flatten(like)
    if manifest["num_leaves"] != len(likes):
        raise ValueError(f"structure mismatch: {manifest['num_leaves']} "
                         f"leaves saved, {len(likes)} expected")
    shs = [None] * len(likes) if shardings is None else flatten_shardings(
        shardings)
    out = []
    for i, (m, l, sh) in enumerate(zip(manifest["leaves"], likes, shs)):
        dev = l.device if isinstance(l, torch.Tensor) else "cpu"
        if sh is None:
            out.append(_read_leaf(os.path.join(path, f"leaf_{i}.npy"),
                                  m["dtype"], dev))
            continue
        want = global_shape(tuple(l.shape), sh)
        if tuple(m["shape"]) != want:
            raise ValueError(f"leaf {i}: saved shape {tuple(m['shape'])}, "
                             f"but its slab {tuple(l.shape)} under the "
                             f"given shardings needs {want}")
        t = _read_leaf(os.path.join(path, f"leaf_{i}.npy"), m["dtype"],
                       "cpu")
        out.append(shard_tensor(t, sh).to(dev))
    return unflatten(like, out)


def flatten_shardings(shardings) -> list:
    """The ``MeshSharding``s of a tree in :func:`flatten` order (a
    ``MeshSharding`` is a tuple: it is a leaf here)."""
    from ..dist.sharding import MeshSharding

    if isinstance(shardings, MeshSharding):
        return [shardings]
    if isinstance(shardings, dict):
        return [s for k in sorted(shardings)
                for s in flatten_shardings(shardings[k])]
    return [s for v in shardings for s in flatten_shardings(v)]


def gather_pytree(tree, shardings, host: bool = True) -> list:
    """``(host array, dtype name)`` of every leaf of ``tree`` (this rank's
    slabs) gathered whole over the mesh of ``shardings``, in
    :func:`flatten` order, one leaf on the device at a time (``host``
    False: gathered and dropped, an empty list).  Every rank must call it
    at the same point."""
    from ..dist.sharding import gather_tensor

    out = []
    for l, sh in zip(flatten(tree), flatten_shardings(shardings)):
        whole = gather_tensor(l, sh)
        if host:
            out.append(_host(whole))
    return out


def latest_step(directory: str):
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") and "tmp-" not in d:
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._barrier = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            # after a sharded save: the writing rank's files are published
            # before any rank goes on to read them
            self._barrier = False
            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier()

    def save(self, step: int, tree, blocking: bool = False, shardings=None):
        """Copies to the host now; writes on a background thread.  With
        ``shardings`` (see the module note) every rank must call it at the
        same step; rank 0 writes."""
        self.wait()
        if shardings is None:
            leaves = [_host(l) for l in flatten(tree)]
        else:
            writer = dist.get_rank() == 0
            leaves = gather_pytree(tree, shardings, host=writer)
            self._barrier = True
            if not writer:
                if blocking:
                    self.wait()
                return
        treedef = treedef_str(tree)
        path = os.path.join(self.directory, f"step_{step}")

        def work():
            _save_host(leaves, treedef, path)
            self._gc()

        if blocking:
            work()
            if shardings is not None:
                self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore_latest(self, like, shardings=None):
        """Returns (tree, step) or (None, None); tensors land on the devices
        of ``like``'s leaves.  With ``shardings`` (a tree of
        ``MeshSharding``s) each leaf is this rank's slab under them and
        ``like`` holds slab shapes: the elastic re-shard."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return load_pytree(os.path.join(self.directory, f"step_{step}"),
                           like, shardings), step

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and "tmp" not in d
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
