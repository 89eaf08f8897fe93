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
