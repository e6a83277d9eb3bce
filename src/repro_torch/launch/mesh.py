"""Local mesh builders over ``torch.distributed``.

Port of ``repro.launch.mesh``'s ``make_local_mesh`` and
``parse_mesh_spec``.  The port's mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names=("data",
"model")``, one process per device (SPMD: every rank runs the same program
on the same global inputs).  The device count is the process group's world
size, and a mesh covers every rank of it.

When no process group exists these functions start one themselves: under
``torchrun`` from its environment (``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR``), otherwise one of world size 1 through a ``FileStore`` in
a fresh temporary directory (no TCP port, so parallel processes cannot
collide), ended and removed at exit. The backend is NCCL on the card and
gloo with ``device="cpu"``. So ``python -m repro_torch.launch.serve --mesh
data=1,model=1`` runs on one card without a launcher.

:func:`make_production_mesh` is the dry-run's (``launch.dryrun``): a
:class:`DryMesh` of the reference's production shapes, (16, 16) over
("data", "model") or (2, 16, 16) over ("pod", "data", "model"), with no
process group and no device behind it.
"""

from __future__ import annotations

import atexit
import datetime
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..dist.comm import DryGroup

__all__ = ["DryMesh", "ensure_process_group", "make_local_mesh",
           "make_production_mesh", "mesh_spec_sizes", "parse_mesh_spec"]

# a collective that waits longer than this raises instead of hanging
PG_TIMEOUT = datetime.timedelta(seconds=300)


def ensure_process_group(device=None) -> torch.device:
    """Start the default process group if none exists (see the module
    note); returns the device this rank's mesh lives on."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=PG_TIMEOUT)
    else:
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=PG_TIMEOUT)
        atexit.register(_end_world1, tmp)
    return dev


def _end_world1(tmp: str) -> None:
    """At exit: end the world-1 group started here (unless the caller
    did) and remove its store."""
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)


class DryMesh:
    """A mesh of ``shape`` over ``names`` seen from the rank at ``coords``
    (rank 0 by default), with no process group and no device: as much of a
    ``DeviceMesh`` as the port's sharding and model code read
    (``mesh_dim_names``, ``shape``, ``get_local_rank``, ``get_group``,
    ``mesh[name]``).  Each axis's group is a ``dist.comm.DryGroup``, so a
    collective over it sends nothing and counts its payload."""

    def __init__(self, shape, names=("data", "model"), coords=None):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} against axes "
                             f"{tuple(names)}")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(names)
        coords = (0,) * len(names) if coords is None else tuple(coords)
        if not all(0 <= c < n for c, n in zip(coords, self.shape)):
            raise ValueError(f"coordinates {coords} outside {self.shape}")
        self.coords = coords

    def size(self) -> int:
        return math.prod(self.shape)

    def get_local_rank(self, name: str) -> int:
        return self.coords[self.mesh_dim_names.index(name)]

    def get_group(self, name: str) -> DryGroup:
        i = self.mesh_dim_names.index(name)
        return DryGroup(self.shape[i], self.coords[i])

    def __getitem__(self, name: str) -> "DryMesh":
        i = self.mesh_dim_names.index(name)
        return DryMesh((self.shape[i],), (name,), (self.coords[i],))


def make_production_mesh(*, multi_pod: bool = False) -> DryMesh:
    """The reference's production meshes as :class:`DryMesh` es: (16, 16)
    over ("data", "model"), or (2, 16, 16) over ("pod", "data", "model").
    "pod" replicates everything: no sharding rule names it."""
    if multi_pod:
        return DryMesh((2, 16, 16), ("pod", "data", "model"))
    return DryMesh((16, 16), ("data", "model"))


def make_local_mesh(data: int = 1, model: int = 1, *, device=None):
    """A (data, model) ``DeviceMesh`` over every rank of the process group
    (started if there is none); ``data * model`` must equal its world
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = ensure_process_group(device)
    world = dist.get_world_size()
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1: data={data} model={model}")
    if data * model != world:
        raise ValueError(f"mesh data={data} x model={model} needs "
                         f"{data * model} ranks; the process group has {world}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_spec_sizes(spec: str, n_dev: int) -> tuple:
    """(data, model) sizes of a CLI mesh string like ``data=2,model=4`` on
    ``n_dev`` devices, with the reference's grammar and errors.

    Each comma-separated entry is ``axis`` or ``axis=N`` with axis in
    {data, model}.  The FIRST entry without ``=N`` absorbs every device the
    other axes leave over; further bare entries get size 1, so on 8 devices
    ``data,model=2`` is 4x2 and ``data,model`` 8x1.  Unnamed axes get size
    1.  Raises ValueError for unknown axes, duplicate entries, non-positive
    sizes, or a layout that does not fit the device count.
    """
    sizes: dict = {}
    wildcard = None
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, num = entry.partition("=")
        name = name.strip()
        if name not in ("data", "model"):
            raise ValueError(f"unknown mesh axis {name!r} (want data/model)")
        if name in sizes or name == wildcard:
            raise ValueError(f"duplicate mesh axis {name!r}")
        if num:
            sizes[name] = int(num)
            if sizes[name] < 1:
                raise ValueError(f"mesh axis {name!r} must be >= 1: {num}")
        elif wildcard is None:
            wildcard = name
        else:
            sizes[name] = 1
    explicit = 1
    for s in sizes.values():
        explicit *= s
    if wildcard is not None:
        if n_dev % explicit:
            raise ValueError(
                f"{explicit} explicit-axis devices do not divide {n_dev}"
            )
        sizes[wildcard] = n_dev // explicit
    total = sizes.get("data", 1) * sizes.get("model", 1)
    if total > n_dev:
        raise ValueError(f"mesh needs {total} devices, only {n_dev} present")
    return sizes.get("data", 1), sizes.get("model", 1)


def parse_mesh_spec(spec: str, *, device=None):
    """Build a (data, model) mesh from a CLI string (grammar:
    :func:`mesh_spec_sizes`) over the process group's ranks (started if
    there is none).  A layout smaller than the world raises in
    :func:`make_local_mesh`: every rank must be in the mesh."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    data, model = mesh_spec_sizes(spec, world)
    return make_local_mesh(data, model, device=device)
