"""The CUDA kernels on the card: each against its plain PyTorch version,
and the aligner on the GPU against the JAX-made golden.

Marked ``gpu``; each test skips where no CUDA device is present.  On a
machine with an H100:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from _torch_synth import (SAMPRATE, TEXT, austen_audio, load_golden,
                          model_dir, segs_rep)
from make_torch_mixed_golden import (load_mixed_golden, mixed_audio,
                                     scored_rep)

from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.fe import feat as fm
from soundswallower_tpu_torch.ops import align_torch as at
from soundswallower_tpu_torch.ops import senscore_torch as st
from soundswallower_tpu_torch.utils import cuda_build

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda_aligner(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return TorchAligner(hmm=model_dir(tmp_path_factory, "small"),
                        samprate=SAMPRATE, device="cuda")


def test_kernels_equal_plain_on_card(cuda_aligner):
    al = cuda_aligner
    audios = [austen_audio(i) for i in range(5)]
    Ts = np.array([al.fe.n_frames(len(a)) for a in audios], np.int32)
    Tmax = -(-int(Ts.max()) // 64) * 64
    pl = torch.from_numpy(al.native_fe.process_list_i16p(
        audios, Tmax, al.wire_scale)).cuda()
    Ts_d = torch.from_numpy(Ts).cuda()
    c = al._graph_consts(al.graph_for_text(TEXT))
    inv = 1.0 / al.wire_scale
    feats = fm.feat(pl, Ts_d, inv, True)
    assert torch.equal(feats, fm.feat_plain(pl, Ts_d, inv, True))
    flat = feats.view(-1, 3, 13)
    s, cw = st.dist_topn_norm(flat, c.gs)
    s_p, cw_p = st.dist_topn_norm_plain(flat, c.gs)
    assert torch.equal(s, s_p) and torch.equal(cw, cw_p)
    sen = st.senone_eval(s, cw, c.gs)
    assert torch.equal(sen, st.senone_eval_plain(s, cw, c.gs))
    sen = sen.view(len(audios), Tmax, -1)
    short = Ts_d.clone()
    short[-1] = 3                                   # a row that fails
    for n in (Ts_d, short):
        path, fs = at.viterbi_batch(sen, n, c.vit)
        path_p, fs_p = at.viterbi_batch_plain(sen, n, c.vit)
        assert torch.equal(path, path_p) and torch.equal(fs, fs_p)


def test_gpu_aligner_matches_golden(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = load_golden()
    al = TorchAligner(hmm=model_dir(tmp_path_factory, "en-us"),
                      samprate=g["samprate"], device="cuda")
    audios = [austen_audio(i) for i in range(len(g["segs"]))]
    wrappers = (fm.feat, st.dist_topn_norm, st.senone_eval, at.viterbi_batch)
    before = [w.launches for w in wrappers]
    out = al.align_batch(audios, [g["text"]] * len(audios))
    assert [segs_rep(s) for s in out] == g["segs"]
    assert all(w.launches > b for w, b in zip(wrappers, before))


@pytest.mark.parametrize("repeat,over_48k", [(10, False), (26, True),
                                              (100, True)])
def test_viterbi_large_graphs_on_card(cuda_aligner, repeat, over_48k):
    """Graphs of about 580, 1,510 and 5,800 phones: several phones per
    thread, and (from 26 repeats) more than the 48 KB of dynamic shared
    memory a block gets without opting in."""
    al = cuda_aligner
    c = al._graph_consts(al.graph_for_text(" ".join([TEXT] * repeat)))
    smem = cuda_build.lib().sst_viterbi_smem_bytes(c.vit.P)
    assert (smem > 48 * 1024) == over_48k, (c.vit.P, smem)
    B, T = 4, 256
    rng = np.random.RandomState(repeat)
    sen = torch.from_numpy(rng.randint(0, 3000, (B, T, c.gs.S))
                           .astype(np.int32)).cuda()
    n = torch.tensor([T, 200, 150, 2], dtype=torch.int32).cuda()
    path, fs = at.viterbi_batch(sen, n, c.vit)
    path_p, fs_p = at.viterbi_batch_plain(sen, n, c.vit)
    assert torch.equal(path, path_p) and torch.equal(fs, fs_p)


def test_viterbi_too_large_graph_raises_on_card(cuda_aligner):
    """A graph whose state needs more shared memory than a block can
    have raises ValueError with the sizes, and launches nothing."""
    al = cuda_aligner
    c = al._graph_consts(al.graph_for_text(" ".join([TEXT] * 130)))
    sen = torch.zeros((1, 64, c.gs.S), dtype=torch.int32, device="cuda")
    n = torch.tensor([64], dtype=torch.int32, device="cuda")
    before = at.viterbi_batch.launches
    with pytest.raises(ValueError, match="shared memory"):
        at.viterbi_batch(sen, n, c.vit)
    assert at.viterbi_batch.launches == before


def _mixed_inputs(al, texts, T=256, seed=0):
    """Stacked graphs of ``texts`` (band form when the graphs allow it)
    and random int32 scores in their column order, on the card."""
    graphs = [al.graph_for_text(t) for t in texts]
    raw = at.stack_graphs(graphs, al.am.tmat.astype(np.int32),
                          np.arange(al.am.n_sen))
    rng = np.random.RandomState(seed)
    sen = torch.from_numpy(rng.randint(0, 3000, (len(texts), T,
                                                 raw["sencols"].shape[1]))
                           .astype(np.int32)).cuda()
    return raw, sen


def test_mixed_kernels_equal_plain_on_card(cuda_aligner):
    """K5 (int32 and int16 sources, wrapped and past-the-end columns),
    K6 (band and K-slot forms, with and without scores, a row that
    reaches no final node) and K7 against their plain versions."""
    al = cuda_aligner
    texts = [TEXT, "young man", "he was not", "an ill man", "was not young"]
    raw, sen = _mixed_inputs(al, texts)
    n = torch.tensor([256, 200, 3, 255, 128], dtype=torch.int32).cuda()
    band = at.row_consts_from_numpy(raw, "cuda")
    kslot = at.row_consts_from_numpy(
        {k: v for k, v in raw.items() if not k.startswith("band")}, "cuda")
    assert band.band_pen is not None and kslot.band_pen is None
    for c in (band, kslot):
        for ws in (False, True):
            got = at.viterbi_rows(sen, n, c, ws)
            want = at.viterbi_rows_plain(sen, n, c, ws)
            for a, b in zip(got, want):
                assert (a is None and b is None) or torch.equal(a, b)
    cols = torch.from_numpy(raw["sencols"]).cuda()
    cols[:, :2] = torch.tensor([-1, 10 ** 6], dtype=torch.int32)
    for dtype in (torch.int32, torch.int16):
        src = sen[:, :, :100].to(dtype).contiguous()
        assert torch.equal(st.gather_cols(src, cols),
                           st.gather_cols_plain(src, cols))
    x = (sen.view(-1, sen.shape[2]) * 37).contiguous()   # wraps in int16
    assert torch.equal(st.frame_best_sub(x), st.frame_best_sub_plain(x))


def test_viterbi_rows_over_48k_on_card(cuda_aligner):
    """K6 on a stack whose largest graph needs more than 48 KB of shared
    memory (the opt-in branch), bit-equal to its plain version."""
    al = cuda_aligner
    texts = [" ".join([TEXT] * 26), "young man", " ".join([TEXT] * 3)]
    raw, sen = _mixed_inputs(al, texts, T=128, seed=1)
    assert cuda_build.lib().sst_viterbi_smem_bytes(raw["P"]) > 48 * 1024
    n = torch.tensor([128, 100, 2], dtype=torch.int32).cuda()
    c = at.row_consts_from_numpy(raw, "cuda")
    for ws in (False, True):
        got = at.viterbi_rows(sen, n, c, ws)
        want = at.viterbi_rows_plain(sen, n, c, ws)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)


def test_gpu_mixed_aligner_matches_golden(tmp_path_factory):
    """The golden's sequence on one fresh aligner on the card: union,
    forced dense, scored, all 32 rows, through K1-K7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = load_mixed_golden()
    al = TorchAligner(hmm=model_dir(tmp_path_factory, "en-us"),
                      samprate=g["samprate"], device="cuda")
    audios = [mixed_audio(i) for i in range(len(g["texts"]))]
    wrappers = (fm.feat, st.dist_topn_norm, st.senone_eval, st.gather_cols,
                at.viterbi_rows, st.frame_best_sub)
    before = [w.launches for w in wrappers]
    assert [segs_rep(s) for s in al.align_batch(audios, g["texts"])] \
        == g["union"]
    al._uni["dense"] = True
    assert [segs_rep(s) for s in al.align_batch(audios, g["texts"])] \
        == g["dense"]
    assert [scored_rep(s) for s in al.align_batch_scored(audios, g["texts"])] \
        == g["scored"]
    assert all(w.launches > b for w, b in zip(wrappers, before))
