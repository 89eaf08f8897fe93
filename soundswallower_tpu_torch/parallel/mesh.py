"""The data-parallel mesh: the batch's rows split over ranks, one device
each, the model and graph tables replicated.

Port of ``soundswallower_tpu/parallel/mesh.py`` (``data_mesh``,
``shard_batch``, ``replicate``).  There a ``('data',)`` mesh of devices
shards the batch axis under GSPMD; here a ``DataMesh`` lists each
rank's device in rank order, and the aligner (``TorchAligner.use_mesh``)
runs each rank's rows on its device.  The alignment pipeline needs no
collective: every stage is row-local, so the ranks share nothing but the
tables each holds a copy of.

Like ``SeqRing``'s local transport (parallel/seqpipe.py), a mesh may
hold n virtual ranks on one device: the CPU in tests, ``cuda:0`` on a
one-card host.  ``data_mesh`` on ``"cuda"`` takes the host's cards,
``cuda:0`` .. ``cuda:n-1``; a CUDA device that is absent raises, and
nothing falls back to the CPU.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..utils import resolve_device


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ranks of a data-parallel mesh: ``devices[r]`` runs rank r's
    rows.  Under several processes (parallel/multihost.py) the mesh is
    this process's ranks, ``process_index`` its place among
    ``process_count`` processes."""

    devices: tuple
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> list:
        """The mesh's devices, each once, in rank order."""
        return list(dict.fromkeys(self.devices))


def data_mesh(n_devices: int | None = None, device="cuda") -> DataMesh:
    """A mesh of ``n_devices`` ranks.  ``device``: ``"cuda"`` for one
    rank a card of this host (``cuda:0`` .. ``cuda:n-1``, all of them by
    default); one device (``"cpu"``, ``"cuda:0"``) for n virtual ranks
    on it (one by default).  A CUDA device that is absent, or more ranks
    than cards on ``"cuda"``, raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if n > count:
            raise RuntimeError(
                f"data_mesh: {n} ranks on {count} CUDA device(s); name one "
                "device (cuda:0) for virtual ranks")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        resolve_device(dev)
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} is absent: the host has "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        devs = [dev] * (1 if n_devices is None else int(n_devices))
    if not devs:
        raise ValueError("data_mesh: a mesh needs a rank")
    return DataMesh(tuple(devs))


def tree_map(fn, tree):
    """fn on every tensor and numpy array of a tree of dicts, lists,
    tuples and objects (the scorer's and the Viterbi's dataclasses, whose
    attributes are mapped on a copy); other leaves are kept."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = copy.copy(tree)
        for k, v in vars(tree).items():
            object.__setattr__(out, k, tree_map(fn, v))
        return out
    return tree


def _to(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_batch(mesh: DataMesh, tree) -> list:
    """The tree's [B, ...] arrays split along dim 0 into the mesh's
    ranks, rank r's rows on its device: a tree per rank.  B must divide
    over the ranks (as the JAX sharding requires)."""
    n = mesh.size
    out = []
    for r, dev in enumerate(mesh.devices):
        def part(x, r=r, dev=dev):
            if x.shape[0] % n:
                raise ValueError(f"shard_batch: {x.shape[0]} rows over {n} "
                                 "ranks")
            k = x.shape[0] // n
            return _to(x[r * k:(r + 1) * k], dev)
        out.append(tree_map(part, tree))
    return out


def replicate(mesh: DataMesh, tree) -> list:
    """The tree on each distinct device of the mesh, once: a tree per
    rank, ranks on one device sharing its copy (a tensor already there
    is not copied)."""
    copies = {d: tree_map(lambda x, d=d: _to(x, d), tree)
              for d in mesh.distinct()}
    return [copies[d] for d in mesh.devices]
