"""K4 (batch Viterbi + final-node select + backtrace): the port's plain
version against the JAX program, bit-equal on random scores."""

import types

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, model_dir

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu_torch.ops import align_torch as at

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_aligner(tmp_path_factory):
    return TpuAligner(hmm=model_dir(tmp_path_factory, "small"),
                      samprate=SAMPRATE)


def _jax_vit(consts: dict, sen: np.ndarray, Ts: np.ndarray):
    """TpuAligner._vit_full (align_viterbi_batch + final select +
    backtrace_batch) on a bare object holding one graph's constants."""
    fake = types.SimpleNamespace(_graph_consts=lambda g: consts,
                                 want_scores=False)
    path, pscore, fscore = TpuAligner._vit_full(fake, None, sen, Ts)
    assert pscore is None
    return np.asarray(path), np.asarray(fscore)


@pytest.mark.parametrize("text,base", [
    ("he was not an ill disposed young man", 0),
    ("young man", 0),
    # every frame costs >= 6e6: the best score crosses the
    # renormalization threshold (state_align_search.c:193-197) mid-row
    ("he was not", 6_000_000),
])
def test_viterbi_matches_jax(jax_aligner, text, base):
    jal = jax_aligner
    g = jal.graph_for_text(text)
    c = jal._graph_consts(g)
    S = g.senid.size
    B, T = 6, 128
    rng = np.random.RandomState(len(text))
    sen = (base + rng.randint(0, 3000, (B, T, S))).astype(np.int32)
    # full rows, short rows, and one too short to reach a final node
    Ts = np.array([T, 100, 77, T, 60, 3], np.int32)
    want_path, want_fs = _jax_vit(c, sen, Ts)
    vc = at.graph_consts_from_numpy(
        {k: np.asarray(v) for k, v in c.items() if k != "gs"})
    path, pscore, fs = at.viterbi_batch(torch.from_numpy(sen),
                                        torch.from_numpy(Ts), vc)
    assert pscore is None
    assert path.dtype == torch.int16 and fs.dtype == torch.int32
    assert want_path[5, Ts[5] - 1] < 0          # the failed row
    assert (path.numpy() == want_path).all()
    assert (fs.numpy() == want_fs).all()
    if base:   # rows of >= 100 frames renormalized: far above the raw sum
        long = Ts >= 100
        assert (fs.numpy()[long] > -base * Ts[long] // 2).all()


def test_build_pred_table_matches_jax(jax_aligner):
    from soundswallower_tpu.ops.align_jax import build_pred_table

    g = jax_aligner.graph_for_text("he was not an ill disposed young man")
    for k_pad in (None, 6):
        want = build_pred_table(g.edge_src, g.edge_dst, g.edge_pen,
                                len(g.senid), k_pad)
        got = at.build_pred_table(g.edge_src, g.edge_dst, g.edge_pen,
                                  len(g.senid), k_pad)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and (a == b).all()


def test_int32_token_stacks_not_ported():
    """S >= 32767 once raised NotImplementedError; it now takes int32
    token stacks and paths, where align_jax.py switches (its value
    tests: tests/test_torch_large_graph.py)."""
    P = 11000                                    # S = 33,000 >= 32767
    c = at.graph_consts_from_numpy(dict(
        tp=np.zeros((P, 3, 4), np.int32), pi=np.zeros((P, 1), np.int32),
        pp=np.zeros((P, 1), np.int32), pk=np.zeros((P, 1), bool),
        ast=np.zeros(P, np.int32), aen=np.full(P, 1 << 30, np.int32),
        entry=np.zeros(P, np.int32), fin=np.array([P - 1], np.int32)))
    path, _, fs = at.viterbi_batch(torch.zeros((1, 4, 3 * P),
                                               dtype=torch.int32),
                                   torch.full((1,), 4, dtype=torch.int32), c)
    assert at.tok_dtype(3 * P) == path.dtype == torch.int32
    assert at.tok_dtype(32766) == torch.int16
    assert fs.dtype == torch.int32 and path.shape == (1, 4)
