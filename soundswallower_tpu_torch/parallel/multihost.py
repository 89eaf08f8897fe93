"""Data parallelism over several processes (hosts), on torch.distributed.

Port of ``soundswallower_tpu/parallel/multihost.py``.  The design keeps
the network off the hot path:

* every process loads the model tables itself (a few MB, replicated,
  never sharded);
* each process feeds its own rows (its own audio; no audio crosses a
  process boundary) to its own devices;
* the alignment pipeline runs no collective, so the process group
  carries no data: one ``all_gather`` of the processes' row counts at
  dispatch gives each its global row offset (``host_batch_to_global``);
* results come back per process (``local_results``).

Usage, one process per host (or per card):

    from soundswallower_tpu_torch.parallel.multihost import (
        initialize, global_data_mesh)

    initialize("tcp://host0:29500", num_processes, process_id)
    al.use_mesh(global_data_mesh())
    segs = al.align_batch(local_audios, local_texts)   # this host's rows

Without a coordinator ``initialize`` does nothing and the mesh is the
local one.  The group defaults to gloo: it carries only the row counts,
and NCCL refuses two ranks on one card, which a one-card host needs for
two processes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import DataMesh, data_mesh, shard_batch, tree_map


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """torch.distributed.init_process_group on ``coordinator_address``
    (``host:port`` or a ``tcp://`` address) with ``num_processes``
    processes, this one ``process_id``; gloo unless ``backend`` is
    given.  Does nothing without a coordinator or where the group is
    already up."""
    if coordinator_address is None or _dist() is not None:
        return
    import torch.distributed as dist

    addr = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend or "gloo", init_method=addr,
                            world_size=num_processes, rank=process_id)


def global_data_mesh(n_devices: int | None = None,
                     device="cuda") -> DataMesh:
    """This process's ranks (``data_mesh(n_devices, device)``) and its
    place among the processes of the default group (0 of 1 without
    one)."""
    mesh = data_mesh(n_devices, device)
    dist = _dist()
    if dist is None:
        return mesh
    return dataclasses.replace(mesh, process_index=dist.get_rank(),
                               process_count=dist.get_world_size())


@dataclasses.dataclass
class GlobalBatch:
    """A batch whose rows are spread over processes: this process's rows
    as one tree per rank of its mesh (``shards``, on the ranks'
    devices), their global offset, and the rows of all processes."""

    shards: list
    offset: int
    total: int

    def map(self, fn) -> "GlobalBatch":
        """fn on each rank's shard (a row-local step), on its device."""
        return dataclasses.replace(self, shards=[fn(s) for s in self.shards])


def _rows(tree) -> int:
    n = set()
    tree_map(lambda x: n.add(x.shape[0]), tree)
    if len(n) != 1:
        raise ValueError(f"a batch's arrays differ in rows: {sorted(n)}")
    return n.pop()


def host_batch_to_global(mesh: DataMesh, local_batch) -> GlobalBatch:
    """This process's [B_host, ...] rows, split over its mesh's ranks
    (``shard_batch``), and their place in the global batch: one
    ``all_gather`` of the processes' row counts, at dispatch.  No row
    leaves its process."""
    rows = _rows(local_batch)
    counts, rank = [rows], 0
    dist = _dist()
    if dist is not None:
        rank = dist.get_rank()
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        mine = torch.tensor([rows], dtype=torch.int64, device=dev)
        got = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(got, mine)
        counts = [int(c) for c in got]
    return GlobalBatch(shard_batch(mesh, local_batch),
                       offset=sum(counts[:rank]), total=sum(counts))


def local_results(batch: GlobalBatch) -> np.ndarray:
    """This process's rows of a GlobalBatch of tensors (a result), in
    order, as numpy: the inverse of host_batch_to_global for outputs."""
    return np.concatenate([s.detach().cpu().numpy() for s in batch.shards])
