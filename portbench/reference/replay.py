"""The reference's recursions over frames, a frame a replay.

The plain versions of K4/K6 (``sst.viterbi._forward_plain``) and of K9
(``sst.frontend.fe_noise_plain``) run some sixty to eighty operator
calls a frame; on a ten-minute chapter that is minutes of launches.
Here each loop body is one step function on persistent state, the
copied body line for line with the frame index a tensor, and on the
card the step is captured once in a CUDA graph and replayed for every
frame (on the CPU it runs as it is).  The operations are the same, so
are the bits; the tests hold both loops to the plain versions.
"""

from __future__ import annotations

import torch

from .sst.frontend import (INV_MAX_GAIN, LAMBDA_A, LAMBDA_B, LAMBDA_POWER,
                           LAMBDA_T, LT_LT, LT_MU, MAX_GAIN, SMOOTH_WINDOW,
                           fma_plain)
from .sst.viterbi import (MISSING, WORST_SCORE, _band_enter,
                          _first_argmax, _hmm3, _hmm5, _kslot_enter,
                          tok_dtype)


def run_frames(step, state: dict, T: int) -> None:
    """step() T times; on the card from a CUDA graph of one step, after
    one eager step (lazy initialisations) whose effect is undone."""
    if T == 0:
        return
    if next(iter(state.values())).device.type != "cuda":
        for _ in range(T):
            step()
        return
    saved = {k: v.clone() for k, v in state.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    for k, v in saved.items():
        state[k].copy_(v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(T):
        graph.replay()
    torch.cuda.synchronize()


def forward(sen, n_frames, tp, astart, aend, entry, enter):
    """``_forward_plain`` without token scores, from the entry scores:
    (the token stack [B, T, S], the carry after the last frame)."""
    B, T, S = sen.shape
    E = tp.shape[-2]
    P = S // E
    update = {3: _hmm3, 5: _hmm5}[E]
    dev = sen.device
    i32 = torch.int32

    def rowwise(x):
        return x[None] if x.ndim == 1 else x

    tpn = {(i, j): rowwise(-tp[..., i, j]).contiguous()
           for i in range(E) for j in range(E + 1)}

    def tprob(i, j):
        return tpn[(i, j)]

    worst = torch.tensor(WORST_SCORE, dtype=i32, device=dev)
    int_min = torch.tensor(-2147483648, dtype=i32, device=dev)
    ast, aen = rowwise(astart), rowwise(aend)
    n = n_frames.to(i32)[:, None]
    score = torch.full((B, P, E), WORST_SCORE, dtype=i32, device=dev)
    score[:, :, 0] = rowwise(entry)
    st = {"score": score,
          "hist": torch.full((B, P, E), -1, dtype=i32, device=dev),
          "osc": torch.full((B, P), WORST_SCORE, dtype=i32, device=dev),
          "ohi": torch.full((B, P), -1, dtype=i32, device=dev),
          "best_prev": torch.zeros((B,), dtype=i32, device=dev),
          "t": torch.zeros((), dtype=i32, device=dev)}
    sidx = torch.arange(S, dtype=i32, device=dev).view(1, P, E)
    tok = torch.empty((B, T, S), dtype=tok_dtype(S), device=dev)
    sen = sen.contiguous()

    def step():
        t = st["t"]
        at = t.long().view(1)
        best_prev = st["best_prev"]
        valid = t < n
        active = (t >= ast) & (t <= aen) & valid
        renorm = ((best_prev - 0x300000) < WORST_SCORE)[:, None, None]
        score = torch.where(renorm & (st["score"] > WORST_SCORE),
                            st["score"] - best_prev[:, None, None],
                            st["score"])
        s = score - sen.index_select(1, at).view(B, P, E)
        score, hist, osc, ohi, best = update(score, st["hist"], st["osc"],
                                             st["ohi"], s, tprob, active,
                                             worst, int_min)
        best = torch.where(active, best, worst).amax(dim=1)
        nf = t + 1
        es, eh, eok = enter(osc, ohi, active & (nf <= aen))
        eh = torch.where(eok, eh, torch.full_like(eh, -1))
        can = eok & (nf >= ast) & (nf <= aen) & valid
        enter_now = can & (~active | (es > score[..., 0]))
        score[..., 0] = torch.where(enter_now, es, score[..., 0])
        hist[..., 0] = torch.where(enter_now, eh, hist[..., 0])
        rec = (active | enter_now)[..., None]
        tok.index_copy_(1, at, torch.where(rec, hist, -1).to(tok.dtype)
                        .view(B, 1, S))
        hist = torch.where(rec, sidx, hist)
        for k, v in (("score", score), ("hist", hist), ("osc", osc),
                     ("ohi", ohi), ("best_prev", best)):
            st[k].copy_(v)
        st["t"].add_(1)

    run_frames(step, st, T)
    return tok, (st["score"], st["hist"], st["osc"], st["ohi"],
                 st["best_prev"])


def backtrace(tok: torch.Tensor, cur: torch.Tensor,
              n_frames: torch.Tensor) -> torch.Tensor:
    """``_backtrace_plain`` without token scores: the path [B, T] from
    the final states ``cur`` [B]."""
    B, T, S = tok.shape
    dev = tok.device
    i32 = torch.int32
    rows = torch.arange(B, device=dev)
    nn = n_frames.to(i32).to(dev)
    path = torch.empty((B, T), dtype=i32, device=dev)
    st = {"cur": cur.to(i32).clone(),
          "t": torch.full((), T - 1, dtype=torch.int64, device=dev)}

    def step():
        t, cur = st["t"], st["cur"]
        inside = (cur >= 0) & (cur < S)
        at = cur.clamp(0, S - 1).long()
        cand = torch.where(inside, tok[rows, t.expand(B), at].to(i32),
                           MISSING)
        path.index_copy_(1, t.view(1),
                         torch.where(t < nn, cur, -1)[:, None])
        st["cur"].copy_(torch.where(t < nn - 1, cand, cur))
        st["t"].sub_(1)

    run_frames(step, st, T)
    return path.to(tok.dtype)


def viterbi_batch(sen, n_frames, c) -> torch.Tensor:
    """``viterbi_batch_plain``'s path (one graph, ``VitConsts``)."""
    tok, (_, _, osc, ohi, _) = forward(
        sen, n_frames, c.tp, c.astart, c.aend, c.entry,
        _kslot_enter(c.pred_idx[None], c.pred_pen[None], c.pred_ok[None]))
    rows = torch.arange(sen.shape[0], device=sen.device)
    fnode = c.fin.long()[_first_argmax(osc[:, c.fin.long()])]
    return backtrace(tok, ohi[rows, fnode], n_frames)


def viterbi_rows(sen, n_frames, c) -> torch.Tensor:
    """``viterbi_rows_plain``'s path (stacked graphs, ``RowVitConsts``)."""
    enter = (_band_enter(c.band_pen, c.band_ok) if c.band_pen is not None
             else _kslot_enter(c.pred_idx, c.pred_pen, c.pred_ok))
    tok, (_, _, osc, ohi, _) = forward(sen, n_frames, c.tp, c.astart,
                                       c.aend, c.entry, enter)
    rows = torch.arange(sen.shape[0], device=sen.device)
    fsc = torch.where(c.final_mask.bool(), osc,
                      torch.full_like(osc, WORST_SCORE))
    node = _first_argmax(fsc)
    fscore = fsc[rows, node]
    fstate = torch.where(fscore > WORST_SCORE, ohi[rows, node],
                         torch.full_like(fscore, -1))
    return backtrace(tok, fstate, n_frames)


def fe_noise(mfspec: torch.Tensor) -> torch.Tensor:
    """``fe_noise_plain`` from a fresh state with every frame advancing
    the carry (``n_frames=None``, the form ``Frontend.mfcc`` takes):
    mfspec float64 [B, T, nfilt] -> the denoised spectra."""
    B, T, nf = mfspec.shape
    dev = mfspec.device
    z = torch.zeros((B, nf), dtype=torch.float64, device=dev)
    st = {"power": z, "noise": z.clone(), "floor": z.clone(),
          "peak": z.clone(),
          "undef": torch.ones(B, dtype=torch.bool, device=dev),
          "t": torch.zeros((), dtype=torch.int64, device=dev)}
    gain = torch.empty_like(mfspec)
    mfspec = mfspec.contiguous()
    # fma_plain's multipliers on the device: a capture copies nothing
    # from the host
    lam_p, lam_a, lam_1a = (torch.tensor(x, dtype=torch.float64, device=dev)
                            for x in (1 - LAMBDA_POWER, LAMBDA_A,
                                      1 - LAMBDA_A))

    def step():
        at = st["t"].view(1)
        mfs = mfspec.index_select(1, at)[:, 0]
        u = st["undef"][:, None]
        p = torch.where(u, mfs, st["power"])
        nz_in = torch.where(u, mfs * INV_MAX_GAIN, st["noise"])
        fl_in = torch.where(u, mfs * INV_MAX_GAIN, st["floor"])
        pk = torch.where(u, torch.zeros_like(mfs), st["peak"])
        p = fma_plain(mfs, lam_p, p * LAMBDA_POWER)
        # _noise_floor(p, nz_in, fl_in, masked=False)
        n_up = fma_plain(nz_in, lam_a, p * (1 - LAMBDA_A))
        nz = torch.where(p >= nz_in, n_up, (nz_in + p) * LAMBDA_B)
        sig = torch.clamp(p - nz, min=1.0)
        f_up = fma_plain(sig, lam_1a, fl_in * LAMBDA_A)
        fl = torch.where(sig >= fl_in, f_up, (fl_in + sig) * LAMBDA_B)
        sig_m = torch.where(sig < pk * LT_LT, pk * LT_MU, sig)
        pk = torch.where(sig > pk * LAMBDA_T, sig, pk * LAMBDA_T)
        sig = torch.maximum(sig_m, fl)
        g = torch.where(sig < p * MAX_GAIN,
                        torch.clamp(sig / p, min=INV_MAX_GAIN),
                        torch.full_like(sig, MAX_GAIN))
        gain.index_copy_(1, at, g[:, None])
        for k, v in (("power", p), ("noise", nz), ("floor", fl),
                     ("peak", pk)):
            st[k].copy_(v)
        st["undef"].fill_(False)
        st["t"].add_(1)

    run_frames(step, st, T)
    lo = torch.clamp(torch.arange(nf, device=dev) - SMOOTH_WINDOW, min=0)
    hi = torch.clamp(torch.arange(nf, device=dev) + SMOOTH_WINDOW,
                     max=nf - 1)
    inv_width = 1.0 / (hi - lo + 1).to(torch.float64)
    coef = torch.zeros_like(gain)
    for o in range(2 * SMOOTH_WINDOW + 1):
        take = (lo + o) <= hi
        j = torch.minimum(lo + o, hi)
        coef = torch.where(take, coef + gain[..., j], coef)
    return mfspec * (coef * inv_width)
