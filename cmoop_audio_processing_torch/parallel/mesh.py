"""Device mesh and placement for population-parallel search.

The counterpart of cmoop_audio_processing_tpu/parallel/mesh.py, with its
names. The scaling model is the JAX package's:

* mesh axes ('pop', 'data'): candidate models are split over 'pop' (each
  pop shard trains its slice of a launch's lanes on its own device, with
  zero collectives on the forward/backward path), and a pop shard's
  training batch is optionally split over its 'data' devices, with the BN
  statistics and the gradients taken over the global batch;
* one controller process per host with several devices, the host-side EA
  reading only the per-generation fitness vector back.

A ``Mesh`` is a (n_pop, n_data) grid of ``torch.device`` with the process
index that owns each entry. In a ``torch.distributed`` world of W
processes, every process builds the mesh from its own local device list
(all of one length) and the global entry list is their concatenation in
rank order; a process runs only the pop shards whose entries it owns. A
local list may repeat a device (``[torch.device("cpu")] * 8``, or
``[cuda:0] * 4`` on a one-GPU machine), the counterpart of the JAX
package's ``--xla_force_host_platform_device_count``.

``torch.distributed.device_mesh`` is not used: it assumes one device per
process. NCCL cannot run two ranks on one GPU, so a one-GPU machine runs a
world of one; several processes are exercised on the CPU with gloo.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.supernet import tree_map


def _world():
    """(world size, rank) of the ``torch.distributed`` world, or (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A ('pop', 'data') grid of devices: ``devices[i, j]`` is pop shard
    i's j-th data device, ``process_index[i, j]`` the rank that owns it.
    ``shape`` reads like JAX's ``mesh.shape["pop"]``."""

    axis_names = ("pop", "data")

    def __init__(self, devices: np.ndarray, process_index: np.ndarray):
        if devices.ndim != 2 or devices.shape != process_index.shape:
            raise ValueError("a mesh is a 2-d grid of devices with owners")
        self.devices = devices
        self.process_index = process_index

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def process_count(self) -> int:
        return len(set(self.process_index.flat))

    def local_pop_shards(self) -> List[int]:
        """The pop shards whose entries this process owns."""
        _, rank = _world()
        return [i for i in range(self.devices.shape[0])
                if (self.process_index[i] == rank).all()]


def population_mesh(
    n_pop_devices: Optional[int] = None,
    n_data_devices: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('pop', 'data') mesh. ``devices`` is this process's local
    device list (default: the visible CUDA devices, ``cuda:0`` up); the
    pop axis defaults to every entry of the world."""
    if devices is None:
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    world, _ = _world()
    devs = [(r, d) for r in range(world) for d in local]
    if n_pop_devices is None:
        n_pop_devices = len(devs) // n_data_devices
    need = n_pop_devices * n_data_devices
    if need > len(devs):
        raise ValueError(
            f"mesh {n_pop_devices}x{n_data_devices} needs {need} devices, "
            f"have {len(devs)}"
        )
    grid = np.empty(need, dtype=object)
    grid[:] = [d for _, d in devs[:need]]
    owner = np.array([r for r, _ in devs[:need]], dtype=np.int64)
    shape = (n_pop_devices, n_data_devices)
    return Mesh(grid.reshape(shape), owner.reshape(shape))


def pop_sharding(mesh: Mesh) -> List[torch.device]:
    """Leading-axis population placement: the device of each pop shard
    (its first data entry), in shard order."""
    return list(mesh.devices[:, 0])


def replicated(mesh: Mesh) -> List[torch.device]:
    """The distinct devices of the mesh this process owns, in mesh order:
    where a replicated operand (the data sets) is placed, once each."""
    _, rank = _world()
    out: List[torch.device] = []
    for d, r in zip(mesh.devices.flat, mesh.process_index.flat):
        if r == rank and d not in out:
            out.append(d)
    return out


def batch_sharding(mesh: Mesh, pop_shard: int = 0) -> List[torch.device]:
    """The data devices of one pop shard: a training batch's rows are
    split over them in this order."""
    return list(mesh.devices[pop_shard])


def shard_population(tree, mesh: Mesh) -> Dict[int, object]:
    """Split a stacked population tree (leading pop axis on every tensor
    leaf) over the mesh's pop shards: {pop shard: its lanes' slice on the
    shard's device}, for the shards this process owns. The leading axis
    divides by the pop width."""
    n_pop = mesh.shape["pop"]
    out = {}
    for i in mesh.local_pop_shards():
        dev = mesh.devices[i, 0]

        def take(x, i=i, dev=dev):
            k = x.shape[0] // n_pop
            return x[i * k:(i + 1) * k].to(dev)

        out[i] = tree_map(take, tree)
    return out


class SplitData:
    """A data set (x, y, w) with a copy on each data device of one pop
    shard, whose batches are split by rows over those devices. ``take``
    gives (xs, ys, ws), lists with one row part per device: the batch's
    rows in equal contiguous parts, part j from copy j. One copy is the
    unsplit data set, and its one part is the plain batch. The trainer
    reads its data only through this type."""

    def __init__(self, copies: Sequence[Tuple[torch.Tensor, ...]]):
        self.copies = [tuple(c) for c in copies]

    @classmethod
    def of(cls, data) -> "SplitData":
        """``data`` itself, or an (x, y, w) triple as one copy."""
        return data if isinstance(data, cls) else cls([data])

    @property
    def rows(self) -> int:
        return self.copies[0][0].shape[0]

    @property
    def device(self) -> torch.device:
        return self.copies[0][0].device

    def take(self, rows) -> Tuple[List[torch.Tensor], ...]:
        """The batch of ``rows`` (a slice or an index tensor)."""
        if len(self.copies) == 1:
            return tuple([a[rows]] for a in self.copies[0])
        if isinstance(rows, slice):
            rows = torch.arange(self.rows)[rows]
        step = rows.shape[0] // len(self.copies)
        parts = [tuple(a[rows[j * step:(j + 1) * step].to(a.device)]
                       for a in copy) for j, copy in enumerate(self.copies)]
        return tuple(list(col) for col in zip(*parts))


def as_parts(t):
    """A batch tensor as the list of its one row part; a list of row parts
    (``SplitData.take``) as it is."""
    return t if isinstance(t, list) else [t]


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """Join a ``torch.distributed`` world of ``num_processes`` at
    ``coordinator_address`` ("host:port", ``tcp://`` init): NCCL for CUDA
    devices, gloo for the CPU. No-op when running single-process."""
    if num_processes is None or num_processes <= 1:
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
