"""The mesh's collectives held on the card, called directly.

Shared by ``chip_smoke.py`` (phase 13) and ``tests/test_torch_gpu.py``.
``dist.comm`` skips every collective over a group of one rank, so a 1x1
mesh issues none on the serving path; :func:`check_collectives` calls
``all_gather_into_tensor``, ``all_reduce`` and ``broadcast`` itself on each
of the mesh's groups, with the int32 boundary codes and the f32 rows the
runtime's shard body gathers.  Every rank draws the same tensors (one
seed), so the gather is ``n`` copies, the sum ``n`` times the tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["check_collectives"]


def check_collectives(mesh, dev, rows: int = 1024, cols: int = 640,
                      seed: int = 0) -> dict:
    """Each collective on each mesh group, int32 and f32; returns
    ``{"groups": {axis: size}, "calls"}``, raises on a wrong result."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes, calls = {}, 0
    for axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
        n = dist.get_world_size(group)
        sizes[axis] = n
        for dtype in (torch.int32, torch.float32):
            t = (torch.randint(0, 256, (rows, cols), generator=gen,
                               device=dev, dtype=dtype)
                 if dtype == torch.int32 else
                 torch.randn(rows, cols, generator=gen, device=dev))
            out = torch.empty((n * rows, cols), dtype=dtype, device=dev)
            dist.all_gather_into_tensor(out, t, group=group)
            red = t.clone()
            dist.all_reduce(red, op=dist.ReduceOp.SUM, group=group)
            got = torch.empty_like(t) if dist.get_rank(group) else t.clone()
            dist.broadcast(got, src=dist.get_global_rank(group, 0),
                           group=group)
            calls += 3
            if not torch.equal(out, t.repeat(n, 1)):
                raise AssertionError(f"all_gather_into_tensor over {axis} "
                                     f"({dtype}): not {n} copies")
            if not torch.equal(red, t * n):
                raise AssertionError(f"all_reduce over {axis} ({dtype}): "
                                     f"not {n} x the tensor")
            if not torch.equal(got, t):
                raise AssertionError(f"broadcast over {axis} ({dtype}): "
                                     "not rank 0's tensor")
    return {"groups": sizes, "calls": calls}
