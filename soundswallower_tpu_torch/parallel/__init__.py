"""Parallel forms of the port: the data-parallel mesh (mesh, multihost:
the counterparts of soundswallower_tpu/parallel/mesh.py and
multihost.py) and the sequence-parallel long form (seqpipe, the
counterpart of soundswallower_tpu/parallel/seqpipe.py)."""

from .mesh import DataMesh, data_mesh, replicate, shard_batch
from .seqpipe import SeqRing, align_longform, seq_ring

__all__ = ["DataMesh", "SeqRing", "align_longform", "data_mesh", "replicate",
           "seq_ring", "shard_batch"]
