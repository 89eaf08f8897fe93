"""Sequence-parallel long-form alignment: the Viterbi carried along a
ring of ranks (B12).

Port of ``soundswallower_tpu/parallel/seqpipe.py``.  The frame axis of a
batch of scores [B, T, S] is cut into nseq chunks of C = T / nseq
frames; rank p of a ``SeqRing`` owns chunk p and keeps only its own
token chunk [B, C, S], so the longest utterance grows with the ring.

* Forward, rank-major: rank p receives the B rows' carries from rank
  p - 1 (one packed tensor), gathers and casts its scores of all rows
  at once, runs frames p*C .. p*C+C-1 of all B rows in one launch of K4's
  carry form (``viterbi_chunk_rows``, one block a row, or a thread-block
  cluster of up to 16 a row past 2,048 phones, each row with its own
  frame count) into its token chunk, and hands the B carries to rank
  p + 1.  Rank 0 starts every row from ``vit_carry0`` with the JAX
  function's 3-state default, so a 5-state model fails here as it does
  there.  A ring makes nseq launches, whatever B.  The rank's int32
  scores of all rows (B*C*S*4 bytes, and the gather's copy where the
  states are remapped) are then held at once, twice the int16 token
  chunk they feed, where the wavefront held one row's: about 49 MB at
  B=4, C=832, S=3,714.
* Final select: the first maximum over the final nodes of the last
  rank's carries.
* Reverse pass: rank p walks its token chunk back from the states rank
  p + 1 hands it, for all B rows in one launch of K13
  (``backtrace_chunk``), and hands the states leaving the chunk to rank
  p - 1.

What differs from the JAX schedule: there the forward is a wavefront
(at ring step k, rank p runs row k - p), which pipelines the rows so
that the ring's separate TPU devices stay busy at once, at B + nseq - 1
steps of one row each.  On this card one row's chunk fills 1 to 16 of
132 SMs (a cluster a row past 2,048 phones; a chapter of 3-10 minutes
takes 8 or 16), so the rows go inside one launch instead of being
pipelined: B
rows cost about what one row did, and a ring of 8 makes 8 launches
where the wavefront made 8 B.  Across cards (the distributed transport)
a rank now waits for all rows of the rank before it, so the ranks no
longer overlap; each card runs all rows at once instead.  Rows are
independent, so neither order changes a path or a score.

A ring has two transports that run the same per-chunk code:

* local: nseq virtual ranks in this process on one device (the JAX
  package's ('seq',) mesh over virtual devices), the carries passed in
  memory;
* distributed: one rank per process of the default ``torch.distributed``
  group (NCCL on the card, gloo on the CPU), the B carries passed with
  one ``send``/``recv`` to the neighbours.  Every rank passes the same
  arguments and keeps only its own chunk of scores and tokens; every
  rank gets the gathered paths and final scores back.

Paths and final scores are bit-equal to the JAX function's and to the
single-device Viterbi and backtrace (tests/test_torch_longform.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.align_torch import (VitConsts, _first_argmax, backtrace_chunk,
                               tok_dtype, vit_carry0, viterbi_chunk_rows)
from .. import spans
from ..utils import resolve_device


class SeqRing:
    """nseq ranks in a line: carries go to rank p + 1 on the forward
    pass and to rank p - 1 on the reverse one."""

    def __init__(self, nseq: int, device, distributed: bool = False):
        if nseq < 1:
            raise ValueError(f"a ring needs a rank, got nseq={nseq}")
        self.nseq = int(nseq)
        self.device = torch.device(device)
        self.distributed = distributed
        self.rank = None
        self._box: dict = {}
        if distributed:
            import torch.distributed as dist

            if dist.get_world_size() != self.nseq:
                raise ValueError(f"nseq={nseq} on a group of "
                                 f"{dist.get_world_size()} processes")
            self.rank = dist.get_rank()

    def ranks(self) -> list[int]:
        """The ranks this process runs."""
        return list(range(self.nseq)) if self.rank is None else [self.rank]

    def send(self, key, x: torch.Tensor, dst: int) -> None:
        if not self.distributed:
            self._box[key] = x
            return
        import torch.distributed as dist

        dist.send(x.contiguous(), dst)

    def recv(self, key, like: torch.Tensor, src: int) -> torch.Tensor:
        if not self.distributed:
            return self._box.pop(key)
        import torch.distributed as dist

        x = torch.empty_like(like)
        dist.recv(x, src)
        return x


def seq_ring(nseq: int | None = None, device="cuda",
             distributed: bool = False) -> SeqRing:
    """A ring of ``nseq`` ranks (seq_mesh's counterpart): local virtual
    ranks on ``device`` (one unless given), or, with ``distributed``,
    this process's rank of the default torch.distributed group (nseq =
    its size)."""
    if distributed:
        import torch.distributed as dist

        return SeqRing(nseq or dist.get_world_size(), device, True)
    return SeqRing(nseq or 1, resolve_device(device))


def _pack(carry) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in carry])


def _unpack(flat: torch.Tensor, like) -> tuple:
    out, i = [], 0
    for x in like:
        out.append(flat[i:i + x.numel()].view(x.shape))
        i += x.numel()
    return tuple(out)


def align_longform(ring: SeqRing, senscr, vit: VitConsts, n_frames,
                   cols=None):
    """Sequence-parallel Viterbi and backtrace over ``ring``.

    senscr [B, T, G] int16 or int32 (numpy or tensor; T divisible by the
    ring's size, frames >= n_frames padding), vit the graph's Viterbi
    tables on the ring's device (``graph_consts_from_numpy``), n_frames
    [B], cols [P, E] the column of senscr each graph state reads (None:
    the identity, G = P * E).  Returns (path [B, T] int32, final_score
    [B] int32) on the ring's device.  Spans ``viterbi`` (the forward
    pass) and ``backtrace`` (the final select and the reverse pass)."""
    nseq, dev = ring.nseq, ring.device
    senscr = torch.as_tensor(senscr)
    B, T, _ = senscr.shape
    if T % nseq:
        raise ValueError(f"the frame axis ({T}) must divide the ring "
                         f"({nseq})")
    with spans.span("viterbi"):
        C = T // nseq
        S = vit.P * vit.E
        nfr = np.asarray(n_frames, np.int64).reshape(B)
        nfr_d = torch.from_numpy(nfr.astype(np.int32)).to(dev)
        if cols is not None:
            cols = torch.as_tensor(cols).reshape(-1).to(dev, torch.int64)
        # each rank's chunk of the scores, on the ring's device
        sen = {p: senscr[:, p * C:(p + 1) * C].to(dev)
               for p in ring.ranks()}

        def chunk_scores(p: int) -> torch.Tensor:
            """Rank p's scores of all rows in graph-state order, int32
            [B, C, S]."""
            x = sen[p]
            if cols is not None:
                x = x.index_select(2, cols)
            return x.to(torch.int32).contiguous()

        # forward, rank-major: rank p runs all B rows in one launch
        carry0 = tuple(x.expand(B, *x.shape)
                       for x in vit_carry0(vit, n_emit=3))
        packed = torch.empty(sum(x.numel() for x in carry0),
                             dtype=torch.int32, device=dev)
        tok = {}
        last = nseq - 1
        fin_score = fin_hist = None
        for p in ring.ranks():
            carry = carry0 if p == 0 else _unpack(
                ring.recv(("f", p), packed, p - 1), carry0)
            tok[p] = torch.empty((B, C, S), dtype=tok_dtype(S), device=dev)
            new, _ = viterbi_chunk_rows(chunk_scores(p), carry, p * C,
                                        nfr_d, vit, out=tok[p])
            if p == last:
                fin_score, fin_hist = new[2], new[3]
            else:
                ring.send(("f", p + 1), _pack(new), p + 1)

    with spans.span("backtrace"):
        # the best final node per row, and the backtrace's start (last rank)
        fstate = fscore = None
        if last in ring.ranks():
            rows = torch.arange(B, device=dev)
            fin = vit.fin.long()
            node = fin[_first_argmax(fin_score[:, fin])]
            fstate = fin_hist[rows, node].contiguous()
            fscore = fin_score[rows, node].contiguous()

        # reverse pass: rank p from the states rank p + 1 hands it
        like = torch.empty(B, dtype=torch.int32, device=dev)
        path = {}
        for p in sorted(ring.ranks(), reverse=True):
            start = fstate if p == last else ring.recv(("b", p), like,
                                                       p + 1)
            path[p], out = backtrace_chunk(tok[p], start, p * C, nfr_d)
            if p > 0:
                ring.send(("b", p - 1), out, p - 1)
        if not ring.distributed:
            return torch.cat([path[p] for p in range(nseq)], dim=1), fscore
        import torch.distributed as dist

        parts = [torch.empty((B, C), dtype=torch.int32, device=dev)
                 for _ in range(nseq)]
        dist.all_gather(parts, path[ring.rank])
        if fscore is None:
            fscore = torch.empty(B, dtype=torch.int32, device=dev)
        dist.broadcast(fscore, last)
        return torch.cat(parts, dim=1), fscore
