"""The CUDA kernels on the card: each against its plain PyTorch version,
and the aligner on the GPU against the JAX-made golden.

Marked ``gpu``; each test skips where no CUDA device is present.  On a
machine with an H100:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_synth import (SAMPRATE, TEXT, austen_audio, load_golden,
                          model_dir, random_graph, segs_rep, stack_random,
                          variant_dir)
from make_torch_backends_golden import (SETS, dense_feats,
                                        load_backends_golden, run_set)
from make_torch_mixed_golden import (load_mixed_golden, mixed_audio,
                                     scored_rep)
from make_torch_synth_golden import REPO

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
        for ws in (False, True):
            _equal(at.viterbi_batch(sen, n, c.vit, ws),
                   at.viterbi_batch_plain(sen, n, c.vit, ws))


def _equal(got, want):
    """Tuples of tensors (or None) equal element for element."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None and b is None) or (
            a.dtype == b.dtype and torch.equal(a, b))


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
    smem = cuda_build.lib().sst_viterbi_smem_bytes(c.vit.P, 3)
    assert (smem > 48 * 1024) == over_48k, (c.vit.P, smem)
    B, T = 4, 256
    rng = np.random.RandomState(repeat)
    sen = torch.from_numpy(rng.randint(0, 3000, (B, T, c.gs.S))
                           .astype(np.int32)).cuda()
    n = torch.tensor([T, 200, 150, 2], dtype=torch.int32).cuda()
    _equal(at.viterbi_batch(sen, n, c.vit),
           at.viterbi_batch_plain(sen, n, c.vit))


def test_viterbi_too_large_graph_raises_on_card(cuda_aligner):
    """A graph whose state needs more shared memory than a block can
    have (130 repeats, P > 7,040) once raised ValueError; it now runs
    with the state in global memory, one launch, bit-equal to the plain
    version, with and without scores, and so do K6 and the carry form."""
    al = cuda_aligner
    c = al._graph_consts(al.graph_for_text(" ".join([TEXT] * 130)))
    lib = cuda_build.lib()
    assert lib.sst_viterbi_smem_bytes(c.vit.P, 3) > at.MAX_SMEM_BYTES
    rng = np.random.RandomState(130)
    sen = torch.from_numpy(rng.randint(0, 3000, (2, 128, c.gs.S))
                           .astype(np.int32)).cuda()
    n = torch.tensor([128, 90], dtype=torch.int32, device="cuda")
    forms = ("3-state, global", "3-state, global, scores")
    before = [at.viterbi_batch.forms.get(f, 0) for f in forms]
    for ws in (False, True):
        _equal(at.viterbi_batch(sen, n, c.vit, ws),
               at.viterbi_batch_plain(sen, n, c.vit, ws))
    assert [at.viterbi_batch.forms.get(f, 0) for f in forms] \
        == [b + 1 for b in before]
    path, fs = at.viterbi_single(sen[0], 128, c.vit)
    _equal((path, fs), at.viterbi_single_plain(sen[0], 128, c.vit))


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
    assert cuda_build.lib().sst_viterbi_smem_bytes(raw["P"], 3) > 48 * 1024
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


# -- the device front end and the Viterbi carry form ---------------------------

FE_SYNTH = dict(sampling_rate=8000, num_filters=20, lower_filt_freq=130,
                upper_filt_freq=3700, transform="dct", lifter_val=22,
                remove_noise=True)
FE_16K = [dict(sampling_rate=16000, fft_size=512, num_filters=40,
               transform="legacy", remove_noise=True),
          dict(sampling_rate=16000, fft_size=512, num_filters=40,
               transform="dct", lifter_val=22, remove_noise=False)]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cfg", [FE_SYNTH] + FE_16K)
def test_fe_kernels_equal_plain_on_card(cfg):
    """K8 (int16 and float32 input), K9 (masked and plain scans, from a
    fresh and from a carried state), K10 (cepstra and log spectra) and
    K1's float32 form against their plain versions on the card."""
    _need_cuda()
    from soundswallower_tpu_torch.fe import frontend as ff

    fe = ff.Frontend(**cfg)
    rng = np.random.RandomState(0)
    B, N = 5, 2 * cfg["sampling_rate"]
    sig = np.clip(np.round(rng.randn(B, N) * 3000), -32768, 32767)
    ns = torch.tensor([N, N - 1, N - 777, 333, 1], dtype=torch.int32).cuda()
    prior = torch.from_numpy(rng.randn(B).astype(np.float32) * 100).cuda()
    T = fe.n_frames(N) + 3
    for x in (torch.from_numpy(sig.astype(np.int16)).cuda(),
              torch.from_numpy(sig.astype(np.float32)).cuda()):
        spec = ff.fe_spec(fe, x, ns, prior, T)
        assert torch.equal(spec, ff.fe_spec_plain(fe, x, ns, prior, T))
    nf = torch.tensor([T, T - 7, 40, 2, 0], dtype=torch.int32).cuda()
    carry = fe.noise_init(B, "cuda")
    for n_frames in (None, nf, nf):
        got = ff.fe_noise(fe, spec, carry, n_frames)
        want = ff.fe_noise_plain(fe, spec, carry, n_frames)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)
        carry = got[1]
    for logspec in (False, True):
        assert torch.equal(ff.fe_cep(fe, spec, logspec),
                           ff.fe_cep_plain(fe, spec, logspec))
    cep = ff.fe_cep(fe, spec)
    n = torch.clamp(nf, min=1)
    assert torch.equal(fm.feat_f32(cep, n, True), fm.feats_plain(cep, n, True))


# K8 and K9 at the edges of their tiling: nfft 128 to 2,048 (16 to 1
# frames a block), 20, 40 and 45 filters (one producer warp, two, and
# two with idle lanes; K9's shared tiles past 48 KB at 40 and 45), and
# remove_dc with one and two levels of the frame sum
FE_EDGES = {
    "nfft128": dict(sampling_rate=4000, fft_size=128, num_filters=20,
                    lower_filt_freq=130, upper_filt_freq=1900,
                    remove_noise=True),
    "nfft256": FE_SYNTH,
    "nfft512-nf40": FE_16K[0],
    "nfft1024-nf45": dict(sampling_rate=16000, fft_size=1024,
                          num_filters=45, remove_noise=True),
    "remove_dc": dict(FE_SYNTH, remove_dc=True),
    "remove_dc-48k": dict(sampling_rate=48000, remove_dc=True,
                          remove_noise=True),
}


@pytest.mark.parametrize("cfg", list(FE_EDGES.values()), ids=list(FE_EDGES))
def test_fe_kernel_tiling_edges_on_card(cfg):
    """K8 and K9 against their plain versions at B = 1 and an odd B of
    33, at T = 1 and one below and one above a multiple of K8's frames a
    block (W) and of K9's frame tile (F); K9 plain and masked, with
    n_frames of 0, mid-tile and past T, from a fresh and a carried
    state; the launch counters move once a call."""
    _need_cuda()
    from soundswallower_tpu_torch.fe import frontend as ff

    fe = ff.Frontend(**cfg)
    rng = np.random.RandomState(3)
    W = ff.spec_frames(fe)
    F = ff.noise_tile(fe.num_filters)
    assert W >= 1 and F >= 1
    form = "remove_dc" if fe.remove_dc else "window"
    for B in (1, 33):
        for T in sorted({1, 4 * W - 1, 4 * W + 1, 2 * F - 1, 2 * F + 1}):
            N = T * fe.frame_shift + fe.frame_size
            sig = np.clip(np.round(rng.randn(B, N) * 3000), -32768, 32767)
            x = torch.from_numpy(sig.astype(np.int16 if B > 1
                                            else np.float32)).cuda()
            ns = rng.randint(0, N + 1, B).astype(np.int32)
            ns[0] = N
            if B > 1:
                ns[1:3] = (1, max(N - 777, 0))
            ns = torch.from_numpy(ns).cuda()
            prior = torch.from_numpy(rng.randn(B).astype(np.float32)
                                     * 100).cuda()
            k0, f0 = ff.fe_spec.launches, ff.fe_spec.forms.get(form, 0)
            spec = ff.fe_spec(fe, x, ns, prior, T)
            assert ff.fe_spec.launches == k0 + 1
            assert ff.fe_spec.forms[form] == f0 + 1
            assert torch.equal(spec, ff.fe_spec_plain(fe, x, ns, prior, T)), \
                (B, T, W)
            nf = rng.randint(0, T + 2, B).astype(np.int32)
            nf[0] = min(F // 2 + 1, T)
            if B > 1:
                nf[1:3] = (0, T)
            nf = torch.from_numpy(nf).cuda()
            carry = fe.noise_init(B, "cuda")
            k0 = ff.fe_noise.launches
            for n_frames in (None, nf, nf):
                got = ff.fe_noise(fe, spec, carry, n_frames)
                want = ff.fe_noise_plain(fe, spec, carry, n_frames)
                assert torch.equal(got[0], want[0]), (B, T, F, n_frames)
                for a, b in zip(got[1], want[1]):
                    assert torch.equal(a, b)
                carry = got[1]
            assert ff.fe_noise.launches == k0 + 3


@pytest.mark.parametrize("nf", [33, 992, 1000, 1024])
def test_fe_noise_wide_on_card(nf):
    """K9 at filter counts past one producer warp: 33 (an idle lane
    past a warp), 992 (31 producer warps and one consumer), 1000 and
    1024 (no room for consumers: the producers smooth their own tiles)
    against its plain version, plain and masked."""
    _need_cuda()
    from soundswallower_tpu_torch.fe import frontend as ff

    fe = ff.Frontend(**FE_SYNTH)
    rng = np.random.RandomState(nf)
    B, T = 3, 2 * ff.noise_tile(nf) + 1
    spec = torch.from_numpy(np.exp(rng.randn(B, T, nf) * 2.5 + 9.0)).cuda()
    nf_d = torch.tensor([T, 0, T // 2], dtype=torch.int32).cuda()
    carry = tuple(torch.zeros((B, nf), dtype=torch.float64).cuda()
                  for _ in range(4)) + (torch.ones(B, dtype=torch.bool)
                                        .cuda(),)
    for n_frames in (None, nf_d):
        got = ff.fe_noise(fe, spec, carry, n_frames)
        want = ff.fe_noise_plain(fe, spec, carry, n_frames)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)
        carry = got[1]


def test_fe_austen_equals_c_golden_on_card():
    _need_cuda()
    import os

    from soundswallower_tpu_torch.fe.frontend import Frontend

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
    audio = np.fromfile(os.path.join(golden, "austen.raw"), np.int16)
    want = np.fromfile(os.path.join(golden, "austen-en", "mfcc.f32"),
                       np.float32).reshape(-1, 13)
    got = Frontend(**FE_SYNTH).process_int16(audio, device="cuda")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("split", [1, 777, 1600])
def test_fe_stream_split_on_card(split):
    """The stream's chunked front end at odd split sizes on the card
    against the plain version on the CPU (the JAX package's values):
    cepstra and carried state after every call."""
    _need_cuda()
    from soundswallower_tpu_torch.fe.frontend import Frontend

    fe = Frontend(**FE_SYNTH)
    audio = austen_audio(1)[:3000 if split == 1 else 12000]
    outs = {}
    for dev in ("cpu", "cuda"):
        raw, prior = np.zeros(0, np.int16), np.float32(0.0)
        noise, got = fe.noise_init(device=dev), []
        for i0 in range(0, len(audio), split):
            raw = np.concatenate([raw, audio[i0:i0 + split]])
            count = 1 + (len(raw) - fe.frame_size) // fe.frame_shift \
                if len(raw) >= fe.frame_size else 0
            if count <= 0:
                continue
            seg = raw[: (count - 1) * fe.frame_shift + fe.frame_size]
            segp = np.zeros(max(2048, -(-len(seg) // 2048) * 2048),
                            np.float32)
            segp[:len(seg)] = seg
            cep, noise = fe.mfcc_chunk(
                torch.from_numpy(segp).to(dev), len(seg),
                max(32, -(-count // 32) * 32), float(prior), noise, count)
            got.append((cep[:count].cpu(), [x.cpu() for x in noise]))
            prior = np.float32(raw[count * fe.frame_shift - 1])
            raw = raw[count * fe.frame_shift:]
        outs[dev] = got
    assert len(outs["cpu"]) == len(outs["cuda"]) > 0
    for (c1, s1), (c2, s2) in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(c1, c2)
        assert all(torch.equal(a, b) for a, b in zip(s1, s2))


def test_viterbi_carry_form_equals_plain_on_card(cuda_aligner):
    """K4's carry form over chunks of 128 frames (the last partial),
    carry and tokens after each, and the single-utterance path with its
    select and backtrace, including an utterance that reaches no final
    state."""
    al = cuda_aligner
    c = al._graph_consts(al.graph_for_text(TEXT)).vit
    rng = np.random.RandomState(4)
    sen = torch.from_numpy(rng.randint(0, 3000, (384, 3 * c.P))
                           .astype(np.int32)).cuda()
    n = 300
    carry_k = carry_p = at.vit_carry0(c)
    for t0 in range(0, 384, 128):
        carry_k, tok_k = at.viterbi_chunk(sen[t0:t0 + 128], carry_k, t0, n, c)
        carry_p, tok_p = at.viterbi_chunk_plain(sen[t0:t0 + 128], carry_p,
                                                t0, n, c)
        assert torch.equal(tok_k, tok_p)
        assert all(torch.equal(a, b) for a, b in zip(carry_k, carry_p))
    for nn in (n, 2):
        path, fs = at.viterbi_single(sen, nn, c)
        path_p, fs_p = at.viterbi_single_plain(sen, nn, c)
        assert torch.equal(path, path_p) and torch.equal(fs, fs_p)


# -- the acoustic-model backends -------------------------------------------------

BACKENDS = ["ptm4b", "semi", "semi4b", "ms", "ms1to1"]


def _backend_feats(n: int = 256) -> torch.Tensor:
    """austen features on the card, frame 0 blown up past every
    distance's clamp and floor, frame 1 partly."""
    f = np.fromfile(os.path.join(REPO, "tests", "golden", "austen-en",
                                 "feat.f32"), np.float32)
    f = f.reshape(-1, 3, 13)[:n].copy()
    f[0] = 1e5
    f[1, :, :4] = 3e3
    return torch.from_numpy(f).cuda()


def _forced_ms(ms):
    """The ms scorer as it is and with ms_gauden.c's edge cases forced:
    a tie (density 1 a copy of density 0), the WORST_DIST floor (all but
    two densities), topn >= D, aw = 2."""
    def rows(t, fn):
        t = t.clone()
        fn(t)
        return t

    def dup(t):
        t[:, :, 1] = t[:, :, 0]

    def huge(t):
        t[:, :, 2:] = 1e9

    return [ms,
            dataclasses.replace(ms, means=rows(ms.means, dup),
                                var_t=rows(ms.var_t, dup),
                                det=rows(ms.det, dup)),
            dataclasses.replace(ms, var_t=rows(ms.var_t, huge)),
            dataclasses.replace(ms, topn=ms.det.shape[2]),
            dataclasses.replace(ms, aw=2)]


@pytest.mark.parametrize("variant", BACKENDS)
def test_backend_kernels_equal_plain_on_card(tmp_path_factory, variant):
    """Per variant (small width): K2/K3 over a graph and over the full
    inventory (K3's wrap_u8 on semi4b), K7 in both forms; for ms, K11
    and K12, also with the forced cases."""
    _need_cuda()
    al = TorchAligner(hmm=variant_dir(tmp_path_factory, variant),
                      samprate=SAMPRATE, device="cuda")
    feats = _backend_feats()
    if variant.startswith("ms"):
        for ms in _forced_ms(al.dense):
            dval, cw = st.ms_dist_topn(feats, ms)
            dp, cp = st.ms_dist_topn_plain(feats, ms)
            assert torch.equal(dval, dp) and torch.equal(cw, cp)
            assert torch.equal(st.ms_senone_eval(dval, cw, ms),
                               st.ms_senone_eval_plain(dval, cw, ms))
        return
    gs = al._graph_consts(al.graph_for_text(TEXT)).gs
    assert gs.wrap_u8 == al.dense.wrap_u8 == (variant == "semi4b")
    assert al.dense.subtract_best == (variant == "ptm4b")
    for sc in (gs, al.dense):
        s, cw = st.dist_topn_norm(feats, sc)
        s_p, cw_p = st.dist_topn_norm_plain(feats, sc)
        assert torch.equal(s, s_p) and torch.equal(cw, cw_p)
        x = st.senone_eval(s, cw, sc)
        assert torch.equal(x, st.senone_eval_plain(s, cw, sc))
    for sub in (True, False):
        assert torch.equal(st.frame_best_sub(x, sub),
                           st.frame_best_sub_plain(x, sub))


def test_gpu_backends_match_golden(tmp_path_factory):
    """tests/golden/torch-synth/backends.json on the card, en-us width:
    every variant's dense scores and rows, each set in the golden's
    order on one fresh aligner."""
    _need_cuda()
    g = load_backends_golden()
    feats = torch.from_numpy(dense_feats()).cuda()
    for variant in ("ptm4b", "semi", "semi4b", "ms"):
        al = TorchAligner(hmm=variant_dir(tmp_path_factory, variant, "en-us"),
                          samprate=g["samprate"], device="cuda")
        got = st.score_frames(al.dense, feats).cpu().numpy()
        assert np.array_equal(got, g[f"{variant}_dense"]), variant
        for name in SETS.get(variant, ()):
            rep = scored_rep if name == "scored" else segs_rep
            rows = [rep(r) for r in run_set(al, variant, name, g["texts"])]
            assert rows == g[variant][name], (variant, name)



# -- the Viterbi's 5-state, int32 and global-state forms ----------------------

# (E, P): just under and just over the shared-memory limit (7,040 phones
# of 3 states, 4,741 of 5), and S >= 32767 (int32 tokens)
VIT_FORMS = [(3, 7040), (3, 7041), (5, 4741), (5, 4742), (3, 11000),
             (5, 6554), (5, 200)]


@pytest.mark.parametrize("E,P", VIT_FORMS)
def test_viterbi_forms_equal_plain_on_card(E, P):
    """K4 (with and without scores), K6 (K-slot and band forms, scores)
    and the carry form (chunks of 16 frames, then the single-utterance
    path) on random graphs against their plain versions: every output
    and dtype, and the forms counted on each wrapper."""
    _need_cuda()
    lib = cuda_build.lib()
    glob = lib.sst_viterbi_smem_bytes(P, E) > at.MAX_SMEM_BYTES
    assert glob == ((E, P) in ((3, 7041), (5, 4742), (3, 11000), (5, 6554)))
    rng = np.random.RandomState(P + E)
    T, S = 48, E * P
    g = random_graph(P, E, rng, T=T)
    c = at.graph_consts_from_numpy(g, "cuda")
    sen = torch.from_numpy(rng.randint(0, 4, (3, T, S)).astype(np.int32)) \
        .cuda()
    n = torch.tensor([T, T - 5, 2], dtype=torch.int32).cuda()
    forms = {k: dict(f.forms) for k, f in (("b", at.viterbi_batch),
                                           ("r", at.viterbi_rows),
                                           ("c", at.viterbi_chunk))}
    for ws in (False, True):
        got = at.viterbi_batch(sen, n, c, ws)
        _equal(got, at.viterbi_batch_plain(sen, n, c, ws))
        assert got[0].dtype == at.tok_dtype(S)
    stacks = [stack_random([g, random_graph(P, E, rng, T=T), g]),
              stack_random([random_graph(P, E, rng, T=T, cyclic=False)
                            for _ in range(3)], band_w=8)]
    for st_ in stacks:
        rc = at.row_consts_from_numpy(st_, "cuda")
        for ws in (False, True):
            _equal(at.viterbi_rows(sen, n, rc, ws),
                   at.viterbi_rows_plain(sen, n, rc, ws))
    ck = cp = at.vit_carry0(c)
    for t0 in range(0, T, 16):
        ck, tk = at.viterbi_chunk(sen[0, t0:t0 + 16], ck, t0, T - 5, c)
        cp, tp_ = at.viterbi_chunk_plain(sen[0, t0:t0 + 16], cp, t0, T - 5, c)
        _equal((tk,) + tuple(ck), (tp_,) + tuple(cp))
    for nn in (T - 5, 2):
        _equal(at.viterbi_single(sen[0], nn, c),
               at.viterbi_single_plain(sen[0], nn, c))
    for k, f, launches in (("b", at.viterbi_batch, 2),
                           ("r", at.viterbi_rows, 4),
                           ("c", at.viterbi_chunk, 5)):
        got = {name: sum(v - forms[k].get(form, 0)
                         for form, v in f.forms.items() if name in form)
               for name in ("5-state", "int32", "global")}
        assert got == {"5-state": launches * (E == 5),
                       "int32": launches * (S >= 32767),
                       "global": launches * glob}, (k, got)


def test_gpu_decode_and_5st_match_cpu(tmp_path_factory):
    """Small width: grammar decode (decode_batch with a failing row,
    decode_batch_scored, decode) and the 5-state model's same, mixed and
    scored batches on the card equal the plain path on the CPU."""
    _need_cuda()
    from make_torch_decode_golden import GRAMMAR, decode_rep
    from make_torch_mixed_golden import scored_rep as srep

    audios = [austen_audio(i) for i in range(3)] + [austen_audio(3)[:1200]]
    for variant in ("ptm", "ptm5st"):
        d = variant_dir(tmp_path_factory, variant)
        out = {}
        for dev in ("cpu", "cuda"):
            al = TorchAligner(hmm=d, samprate=SAMPRATE, device=dev)
            al.set_grammar(jsgf_string=GRAMMAR)
            texts = [TEXT, "young man", "he was not", "an ill man"]
            out[dev] = (
                [decode_rep(r) for r in al.decode_batch(audios)],
                [decode_rep(r) for r in al.decode_batch_scored(audios)],
                decode_rep(al.decode(audios[0])),
                [segs_rep(s) for s in al.align_batch(audios, [TEXT] * 4)],
                [segs_rep(s) for s in al.align_batch(audios, texts)],
                [srep(s) for s in al.align_batch_scored(audios, texts)])
        assert out["cpu"] == out["cuda"], variant
        assert out["cpu"][0][-1] is None


def _segment_limit(R, S, nbytes):
    """The shortest chunk K13's launcher cuts into segments (L < C)."""
    lib = cuda_build.lib()
    C = 2
    while lib.sst_backtrace_segment_len(R, C, S, nbytes) == C:
        C += 1
        assert C < 10 ** 5
    return C


@pytest.mark.parametrize("C", [1, "below", "above", 96, 832, 3737])
@pytest.mark.parametrize("dtype,S", [(torch.int16, 1700),
                                     (torch.int32, 40000)])
def test_backtrace_chunk_equals_plain_on_card(dtype, S, C):
    """K13 against its plain version on random token chunks (states, -1
    and states past either end), start states that include negative ones
    down to -S - 3, frame counts that end 13 frames before the chunk's
    end, inside a segment, at the chunk's last, first and before its
    first frame, at 0 and past the chunk, in a chunk that does not start
    at frame 0; C of 1, one either side of the launcher's single-segment
    limit, 96, 832 and 3,737 (neither of the last two a multiple of the
    segment length the launcher takes)."""
    _need_cuda()
    R, t0 = 7, 192
    nbytes = 2 if dtype == torch.int16 else 4
    if C in ("below", "above"):
        C = _segment_limit(R, S, nbytes) - (C == "below")
    L = cuda_build.lib().sst_backtrace_segment_len(R, C, S, nbytes)
    assert (L == C) == (C < _segment_limit(R, S, nbytes))
    if C >= 832:
        assert C % L and L * L >= C > (L - 1) * (L - 1)
    gen = torch.Generator(device="cuda").manual_seed(S + C)
    tok = torch.randint(-1, S, (R, C, S), generator=gen, device="cuda",
                        dtype=torch.int32)
    wild = torch.rand((R, C, S), generator=gen, device="cuda") < 0.02
    tok[wild] = torch.randint(-S - 9, S + 9, (int(wild.sum()),),
                              generator=gen, device="cuda",
                              dtype=torch.int32)
    tok = tok.to(dtype)
    start = torch.tensor([0, 5, S - 1, -1, -7, -S - 3, 11],
                         dtype=torch.int32).cuda()
    mid = t0 + C // 2 + min(L, C) // 3    # ends inside a segment
    n = torch.tensor([t0 + C, t0 + C - 13, t0 + 1, t0, 0, 10 ** 6, mid],
                     dtype=torch.int32).cuda()
    before = at.backtrace_chunk.launches
    got = at.backtrace_chunk(tok, start, t0, n)
    assert at.backtrace_chunk.launches == before + 1
    want = at.backtrace_chunk_plain(tok, start, t0, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _k3_inputs(N, S, Cu, F, D, topn, layout, rng, wrap=False, high=False,
               n_tab=256):
    """Random K3 inputs on the card: s in [0, 96] with cw in [0, D) (K2's
    range), weights with 0 and 255, a table of ``n_tab`` entries from 255
    down (0 from entry 510), and cb_pos laid out as ``layout``: "graph"
    (runs of 3 columns of random codebooks, as a graph's phones),
    "union" (one codebook), "inventory" (sorted runs, as sen2cb),
    "distinct" (every column of a range a codebook of its own).  With
    ``high``, s in [400, 511] with cw 0 (weight 255) or 1 (weight 0),
    and frame 2's terms 0, ..., 0, 766: the running log-add falls below
    0, so a later difference passes the staged table's end."""
    import types

    if layout == "graph":
        cb = np.repeat(rng.randint(0, Cu, -(-S // 3)), 3)[:S]
    elif layout == "union":
        cb = np.zeros(S, np.int64)
    elif layout == "inventory":
        cb = np.sort(rng.randint(0, Cu, S))
    else:
        cb = np.arange(S) % Cu
    mixw = rng.randint(0, 256, (F, D, S)).astype(np.uint8)
    mixw[:, 0, ::7] = 255
    mixw[:, 1, ::5] = 0
    table = np.maximum(0, 255 - np.arange(n_tab) // 2).astype(np.int32)
    s = rng.randint(0, 97, (N, Cu, F, topn)).astype(np.int32)
    cw = rng.randint(0, D, (N, Cu, F, topn)).astype(np.int32)
    if high:
        mixw[:, 0], mixw[:, 1] = 255, 0
        s = rng.randint(400, 512, (N, Cu, F, topn)).astype(np.int32)
        cw = rng.randint(0, 2, (N, Cu, F, topn)).astype(np.int32)
        if N > 3:
            s[2], cw[2] = 0, 1
            s[2, :, :, -1], cw[2, :, :, -1] = 511, 0
    gs = types.SimpleNamespace(
        mixw=torch.from_numpy(mixw).cuda(),
        cb_pos=torch.from_numpy(cb.astype(np.int32)).cuda(),
        logadd=torch.from_numpy(table).cuda(), S=S, wrap_u8=wrap)
    return torch.from_numpy(s).cuda(), torch.from_numpy(cw).cuda(), gs


K3_CASES = [
    # layout, S, Cu, F, D, topn, wrap_u8
    ("graph", 174, 42, 3, 128, 4, False),      # 64-column ranges
    ("graph", 1000, 42, 3, 128, 8, False),
    ("graph", 37, 20, 1, 128, 1, False),       # 32-column ranges
    ("union", 462, 1, 3, 128, 4, True),
    ("union", 512, 1, 1, 64, 8, True),
    ("inventory", 5126, 42, 3, 128, 4, False),
    ("inventory", 5126, 42, 1, 100, 1, True),
    ("distinct", 1024, 128, 3, 128, 8, False),  # passes of a few frames
    ("distinct", 1000, 300, 4, 128, 4, True),
    # s in [400, 511]; then the same against a table past the staged one
    ("graph", 174, 42, 3, 128, 8, False, "high"),
    ("inventory", 5126, 42, 3, 128, 4, True, "high"),
    ("graph", 1000, 42, 3, 128, 8, False, "high", 800),
]


def _k3_case_id(c) -> str:
    return (f"{c[0]}-S{c[1]}-Cu{c[2]}-F{c[3]}-top{c[5]}"
            f"{'-wrap' if c[6] else ''}"
            + "".join(f"-{x}" if isinstance(x, str) else f"-table{x}"
                      for x in c[7:]))


@pytest.mark.parametrize("case", K3_CASES,
                         ids=[_k3_case_id(c) for c in K3_CASES])
def test_senone_eval_layouts_equal_plain_on_card(case):
    """K3 against its plain version: graph-like interleaved codebooks,
    the union's one codebook, the full inventory's sorted runs, ranges
    of all-distinct codebooks whose terms take the tile in several
    passes of frames (asserted);
    top-N 1, 4 and 8, F 1 and 3, wrap_u8 on and off; S not a multiple of
    the column range; N at the launcher's tile, at a remainder and one
    frame; log-add differences at 255 and past the table's end (s 96
    with weight 255 against s 0 with weight 0), and past the staged
    table's end (s in [400, 511], the running log-add below 0); a table
    longer than the staged one; and a frame with s outside the packed
    range (-3, 600, 2^20), which its pass reads from global memory."""
    _need_cuda()
    layout, S, Cu, F, D, topn, wrap = case[:7]
    high = "high" in case[7:]
    n_tab = case[8] if len(case) > 8 else 256
    rng = np.random.RandomState(S + Cu + topn)
    G, tile, sub = st.senone_eval_layout(64, S, Cu, F, topn)
    if layout == "distinct":
        assert G == 128 and sub < tile
    if S in (174, 37):
        assert G == (64 if S == 174 else 32) and S % G
    for N in sorted({1, tile, 2 * tile + 5}):
        G, tile, sub = st.senone_eval_layout(N, S, Cu, F, topn)
        s, cw, gs = _k3_inputs(N, S, Cu, F, D, topn, layout, rng, wrap,
                               high, n_tab)
        if N > 2:
            # differences of 351 (past the table) and 255 (its last entry)
            # where columns meet weight 255 (cw 0) and 0 (cw 1)
            for q, top in ((0, 96), (1, 0)):
                s[q, :, :, 0], cw[q, :, :, 0] = top, 0
                s[q, :, :, -1], cw[q, :, :, -1] = 0, 1
            s[-1, :, 0, :] = torch.tensor(
                np.resize([-3, 600, 2 ** 20, 7], topn), dtype=torch.int32)
        got = st.senone_eval(s, cw, gs)
        want = st.senone_eval_plain(s, cw, gs)
        assert torch.equal(got, want), (N, G, tile, sub)
        # into rows of a larger buffer, as the batch path's out=
        buf = torch.full((N + 2, S), -5, dtype=torch.int32, device="cuda")
        st.senone_eval(s, cw, gs, out=buf[1:N + 1])
        assert torch.equal(buf[1:N + 1], want)
        assert bool((buf[0] == -5).all() and (buf[-1] == -5).all())


def test_longform_on_card_equals_cpu(tmp_path_factory):
    """Small width: align_longform_batch on local rings of 1, 2 and 8 on
    the card equals the plain path on the CPU and align_batch."""
    _need_cuda()
    from soundswallower_tpu_torch.parallel import seq_ring

    d = model_dir(tmp_path_factory, "small")
    k = 2
    text = " ".join([TEXT] * k)
    audio = np.tile(austen_audio(0), k)
    audios = [audio, audio[:-5000]]
    cpu = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    want = [segs_rep(s) for s in cpu.align_longform_batch(audios, [text] * 2)]
    al = TorchAligner(hmm=d, samprate=SAMPRATE, device="cuda")
    for nseq in (1, 2, 8):
        got = al.align_longform_batch(audios, [text] * 2,
                                      ring=seq_ring(nseq, "cuda"))
        assert [segs_rep(s) for s in got] == want
    assert [segs_rep(s) for s in al.align_batch(audios, [text] * 2)] == want


def test_mxu_kernel_equals_plain_on_card(cuda_aligner):
    """K2's mxu form against its plain version on the graph scorer and on
    the full inventory, and the mxu entry points on the card against the
    CPU."""
    al = cuda_aligner
    rng = np.random.RandomState(2)
    feats = torch.from_numpy(rng.randn(300, 3, 13).astype(np.float32)
                             * 4).cuda()
    feats[0] = 1e5
    c = al._graph_consts(al.graph_for_text(TEXT))
    for sc in (c.gs, al.dense):
        before = st.dist_topn_norm.forms.get("mxu", 0)
        s, cw = st.dist_topn_norm(feats, sc, "mxu")
        assert st.dist_topn_norm.forms["mxu"] == before + 1
        s_p, cw_p = st.dist_topn_norm_plain(feats, sc, "mxu")
        assert torch.equal(s, s_p) and torch.equal(cw, cw_p)
    audios = [austen_audio(i) for i in range(3)]
    cpu = TorchAligner(hmm=al.config["hmm"], samprate=SAMPRATE, device="cpu")
    for texts in ([TEXT] * 3, [TEXT, "young man", "he was not"]):
        assert [segs_rep(s) for s in al.align_batch(audios, texts, "mxu")] \
            == [segs_rep(s) for s in cpu.align_batch(audios, texts, "mxu")]


@pytest.mark.parametrize("rate", [8000, 16000, 48000])
def test_remove_dc_kernel_equals_plain_on_card(rate):
    """K8's remove_dc branch (one and two levels of the frame sum's tree)
    against its plain version, int16 and float32 input, with a DC
    offset."""
    _need_cuda()
    from soundswallower_tpu_torch.fe import frontend as ff

    fe = ff.Frontend(sampling_rate=rate, remove_dc=True)
    rng = np.random.RandomState(rate)
    B, N = 4, rate
    sig = np.clip(np.round(rng.randn(B, N) * 3000 + 2500), -32768, 32767)
    ns = torch.tensor([N, N - 1, N - 777, 333], dtype=torch.int32).cuda()
    prior = torch.from_numpy(rng.randn(B).astype(np.float32) * 100).cuda()
    T = fe.n_frames(N) + 2
    for x in (torch.from_numpy(sig.astype(np.int16)).cuda(),
              torch.from_numpy(sig.astype(np.float32)).cuda()):
        before = ff.fe_spec.forms.get("remove_dc", 0)
        got = ff.fe_spec(fe, x, ns, prior, T)
        assert ff.fe_spec.forms["remove_dc"] == before + 1
        assert torch.equal(got, ff.fe_spec_plain(fe, x, ns, prior, T))


@pytest.mark.parametrize("F", [32, 64, 200, 400, 1024, 4096])
def test_yin_kernel_equals_plain_on_card(F):
    """K14 against yin_cmnd_plain on frames of austen.raw: the CMND bit
    for bit, period and best equal, int16 and float32 input, and lags
    past the frame's end (ndiff > F // 2)."""
    _need_cuda()
    from soundswallower_tpu_torch import yin

    a = np.fromfile(os.path.join(REPO, "tests", "golden", "austen.raw"),
                    np.int16)
    fr = np.stack([a[p:p + F] for p in range(0, len(a) - F, 160)])
    thr = float(np.float32(0.1 * 32768))
    for x in (torch.from_numpy(fr).cuda(),
              torch.from_numpy(fr.astype(np.float32) * 0.5).cuda()):
        for nd in (F // 2, F // 2 + F // 4):
            before = yin.yin_cmnd.launches
            got = yin.yin_cmnd(x, nd, thr)
            assert yin.yin_cmnd.launches == before + 1
            want = yin.yin_cmnd_plain(x, nd, thr)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[2].view(torch.int32),
                               want[2].view(torch.int32))


def _bits_equal(got, want) -> bool:
    """Tensors or tuples of them equal bit for bit (float32 as int32)."""
    if isinstance(got, tuple):
        return all(_bits_equal(a, b) for a, b in zip(got, want))
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.dtype == want.dtype and torch.equal(got, want)


def _feat_rows(rng, B: int, T: int, offset: int, ncep: int = 13):
    """K1's inputs on the card: byte planes and float32 cepstra of the
    same values, each starting ``offset`` elements into its buffer (1:
    off every vector boundary, the scalar loads), and frame counts with
    a full row, an all-negative c0 row, none, one, one past T and the
    rest mid-row."""
    c = rng.normal(0, 6, (B, T, ncep))
    c[:, :, 0] = np.where(rng.random_sample((B, T)) < 0.3,
                          -rng.random_sample((B, T)) * 5,
                          5 + rng.random_sample((B, T)) * 20)
    c[min(1, B - 1), :, 0] = -2.0
    v = np.clip(np.round(c * 128), -32768, 32767).astype(np.int16)
    u = v.view(np.uint16)
    pl = np.stack([(u & 0xFF).astype(np.uint8), (u >> 8).astype(np.uint8)])
    buf = torch.zeros(pl.size + offset, dtype=torch.uint8, device="cuda")
    planes = buf[offset:].view(pl.shape)
    planes.copy_(torch.from_numpy(pl))
    fbuf = torch.zeros(v.size + offset, dtype=torch.float32, device="cuda")
    cep = fbuf[offset:].view(B, T, ncep)
    cep.copy_(torch.from_numpy(v.astype(np.float32) / 100))
    n = rng.randint(T // 2, T + 1, B).astype(np.int32)
    n[0] = T
    for i, k in zip(range(2, B), (0, 1, T + 40)):
        n[i] = k
    return planes, cep, torch.from_numpy(n).cuda()


@pytest.mark.parametrize("layout", [(0, 0, 0), (2, 0, 0), (1, 32, 16),
                                    (1, 64, 128), (2, 1024, 32), (0, 0, 64),
                                    (2, 1024, 0), (1, 96, 0), (1, 256, 0)])
def test_feat_layouts_equal_plain_on_card(layout):
    """K1's byte-plane and float32 forms in every layout (rows a fold
    block, frames a pass, frames a tile; tile 0 the one-launch form where
    the rows fit a pass, which 32 rows or more take by default) forced
    where the launcher would not pick it, with CMN and without, on rows
    of 320, 333 (no multiple of 4: no 16-byte loads or stores), 1,500
    (passes) and 70 frames, at aligned and unaligned starts, against the
    plain versions bit for bit; a layout the launcher cannot run
    raises."""
    _need_cuda()
    rng = np.random.RandomState(14)
    for B, T, offset in ((40, 320, 0), (8, 333, 0), (3, 1500, 0),
                         (5, 70, 1), (40, 320, 1)):
        planes, cep, n = _feat_rows(rng, B, T, offset)
        for cmn in (True, False):
            got = fm.feat_at(planes, n, 1 / 128, cmn, *layout)
            assert _bits_equal(got, fm.feat_plain(planes, n, 1 / 128, cmn))
            got = fm.feat_f32_at(cep, n, cmn, *layout)
            assert _bits_equal(got, fm.feats_plain(cep, n, cmn))
    assert fm.feat_layout(40, 320, 13, True)["tile"] == 0
    assert fm.feat_layout(8, 320, 13, True)["launches"] == 2
    assert fm.feat_layout(4, 6656, 13, True)["pass_frames"] == 1024
    for bad in ((3, 0, 0), (0, 48, 0), (0, 0, 300), (2, 0, 0, 20)):
        with pytest.raises(RuntimeError):
            if len(bad) == 4:
                fm.feat_layout(8, 320, bad[3], True, *bad[:3])
            else:
                fm.feat_at(planes, n, 1 / 128, True, *bad)


@pytest.mark.parametrize("ncep,B,T,layout,launches", [
    (16, 140, 1000, (0, 0, 0), 1), (16, 140, 1000, (2, 0, 0), 2),
    (40, 8, 320, (0, 0, 0), 2), (40, 40, 320, (0, 0, 0), 1),
    (128, 40, 300, (0, 0, 0), 2), (128, 3, 1500, (0, 0, 0), 2),
    (128, 3, 1500, (1, 64, 0), 2)])
def test_feat_wide_cepstra_on_card(ncep, B, T, layout, launches):
    """K1 where the launcher's first choice would pass the card's shared
    memory a block (two rows of 16 dimensions a fold block at 1,000
    frames, 128 dimensions) and past 32 dimensions (a lane folds several
    chains): it takes one row a block, the two-launch form or shorter
    passes, bit-equal to the plain versions; a forced fold that does not
    fit raises, from feat_layout as from the launch."""
    _need_cuda()
    rng = np.random.RandomState(ncep + B)
    planes, cep, n = _feat_rows(rng, B, T, 0, ncep)
    lay = fm.feat_layout(B, T, ncep, True, *layout)
    assert lay["launches"] == launches
    if layout == (0, 0, 0):
        assert lay["rows"] == 1
    for cmn in (True, False):
        got = fm.feat_at(planes, n, 1 / 128, cmn, *layout)
        assert _bits_equal(got, fm.feat_plain(planes, n, 1 / 128, cmn))
        got = fm.feat_f32_at(cep, n, cmn, *layout)
        assert _bits_equal(got, fm.feats_plain(cep, n, cmn))
    if ncep == 128 and T > 1024:
        with pytest.raises(RuntimeError):
            fm.feat_layout(B, T, ncep, True, 1, 1024, 0)
        with pytest.raises(RuntimeError):
            fm.feat_at(planes, n, 1 / 128, True, 1, 1024, 0)


@pytest.mark.parametrize("layout", [(0, 0), (4, 0), (8, 0), (4, 64),
                                    (4, 128), (8, 64), (8, 128)])
def test_yin_layouts_equal_plain_on_card(layout):
    """K14 in every layout (R lags a thread, threads a block: a frame a
    block, or lag tiles of a frame with the second launch) forced where
    the launcher would not pick it, on
    austen.raw's frames at frame sizes 32-4096 with ndiff F / 2, past it
    (lags past the frame) and F, int16 and float32 input with a constant
    frame (ties, the CMND under the threshold at lag 1) and an infinity
    (NaN lags), against yin_cmnd_plain bit for bit; a layout the
    launcher cannot run raises."""
    _need_cuda()
    from soundswallower_tpu_torch import yin

    a = np.fromfile(os.path.join(REPO, "tests", "golden", "austen.raw"),
                    np.int16)
    thr = float(np.float32(0.1 * 32768))
    for F in (32, 100, 200, 400, 1024, 4096):
        fr = np.stack([a[p:p + F] for p in range(0, len(a) - F, 160)])[:9]
        f32 = fr.astype(np.float32) * 0.5
        f32[0] = 12.0
        f32[1, F // 3] = np.inf
        for x in (torch.from_numpy(fr).cuda(), torch.from_numpy(f32).cuda()):
            for nd in sorted({F // 2, F // 2 + 37 if F > 74 else F, F}):
                for t in (thr, 0.0):
                    got = yin.yin_cmnd_at(x, nd, t, *layout)
                    assert _bits_equal(got, yin.yin_cmnd_plain(x, nd, t))
    assert yin.yin_layout(124, 2048)["launches"] == 2
    assert yin.yin_layout(149, 100)["launches"] == 1
    for bad in ((5, 0), (4, 96), (4, 32)):
        with pytest.raises(RuntimeError):
            yin.yin_layout(10, 200, *bad)


def test_decoder_on_card_equals_cpu(tmp_path_factory):
    """The exact Decoder with its front end on the card (K8-K10) against
    device="cpu": the API golden's scenario (alignment JSON at levels
    0-2, a grammar's hyp, segments and n-best, a live decode in
    1,600-sample pieces with its CMN state), spectrogram raw and smooth,
    and pitch_batch (K14) against its CPU route."""
    _need_cuda()
    from make_torch_api_golden import austen_frames, decoder_results

    from soundswallower_tpu_torch import yin
    from soundswallower_tpu_torch.decoder import Decoder

    d = model_dir(tmp_path_factory, "small")
    beams = dict(beam=1e-200, pbeam=1e-200, wbeam=1e-200)

    def short(i):
        return austen_audio(i)[:12000]

    before = fe_launches()
    got = decoder_results(Decoder, d, audio=short, text="he was not an ill",
                          device="cuda", **beams)
    assert all(v > b for v, b in zip(fe_launches(), before))
    assert got == decoder_results(Decoder, d, audio=short,
                                  text="he was not an ill", device="cpu",
                                  **beams)
    a = short(0)
    gpu = Decoder(hmm=d, samprate=SAMPRATE, device="cuda", **beams)
    cpu = Decoder(hmm=d, samprate=SAMPRATE, device="cpu", **beams)
    for smooth in (False, True):
        assert np.array_equal(gpu.spectrogram(a, smooth),
                              cpu.spectrogram(a, smooth))
    fr = austen_frames(400)
    for g, c in zip(yin.pitch_batch(fr), yin.pitch_batch(fr, device="cpu")):
        assert g.is_cuda and torch.equal(g.cpu(), c)


def fe_launches():
    from soundswallower_tpu_torch.fe import frontend as ff

    return ff.fe_spec.launches, ff.fe_noise.launches, ff.fe_cep.launches


# -- K10's and K7's edge shapes ------------------------------------------------

def _bits(t):
    """t's bits as integers (float32 -> int32, float64 -> int64)."""
    return {torch.float32: lambda: t.view(torch.int32),
            torch.float64: lambda: t.view(torch.int64)}.get(t.dtype,
                                                             lambda: t)()


def _off16(x):
    """A copy of the contiguous x whose storage starts 8 bytes (float64)
    or 4 bytes (int32) past a 16-byte boundary: a slice of a buffer one
    element longer."""
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    y = buf[1:].view(x.shape)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


@pytest.mark.parametrize("lifter", [0, 22])
@pytest.mark.parametrize("transform", ["dct", "htk", "legacy"])
@pytest.mark.parametrize("nfilt", [20, 40])
def test_fe_cep_forms_equal_plain_on_card(nfilt, transform, lifter):
    """K10's cepstra and log spectra against fe_cep_plain, bit for bit:
    M of 1, 7, 8k+3 and 81,920 frames (the device-FE path's B=256 x
    320), 20 and 40 filters, each transform with and without a lifter,
    from aligned storage and from storage off a 16-byte boundary; the
    launches counted per form."""
    _need_cuda()
    from soundswallower_tpu_torch.fe import frontend as ff

    fe = ff.Frontend(**(dict(FE_SYNTH, transform=transform,
                             lifter_val=lifter) if nfilt == 20 else
                        dict(FE_16K[0], transform=transform,
                             lifter_val=lifter)))
    assert fe.num_filters == nfilt
    for M in (1, 7, 8 * 37 + 3, 81920):
        rng = np.random.RandomState(M + nfilt)
        v = rng.exponential(1e5, (M, nfilt))
        v[rng.rand(M, nfilt) < 0.05] = 0.0        # the log floor alone
        v[rng.rand(M, nfilt) < 0.05] = 1e-9
        x = torch.from_numpy(v).cuda()
        for src in (x, _off16(x)):
            for logspec, form in ((False, "cepstra"), (True, "logspec")):
                before = ff.fe_cep.forms.get(form, 0)
                got = ff.fe_cep(fe, src, logspec)
                assert ff.fe_cep.forms[form] == before + 1
                want = ff.fe_cep_plain(fe, src, logspec)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.equal(_bits(got), _bits(want)), (M, logspec)


@pytest.mark.parametrize("N", [1, 10240])
@pytest.mark.parametrize("S", [1, 3, 5126, 5127])
def test_frame_best_sub_forms_equal_plain_on_card(S, N):
    """K7's ptm and semi forms against frame_best_sub_plain: S of 1, 3,
    5,126 (en-us) and 5,127, N of 1 and 10,240 (the dense route's B=32 x
    320), int32 scores past the int16 range (the wrap), each row's
    minimum placed in turn in its unaligned head, its tail and its
    middle, from aligned storage and from storage off a 16-byte
    boundary; the launches counted per form."""
    _need_cuda()
    rng = np.random.RandomState(S + N)
    x = rng.randint(-400000, 70000, (N, S)).astype(np.int64)
    x[rng.rand(N, S) < 0.01] = 2 ** 31 - 1
    # rows start at n * S: the head is the first (-n * S) % 4 scores
    for n in range(N):
        head = (-n * S) % 4
        tail = (n * S + S) % 4 if S > head else 0
        p = [0, head - 1, S - 1, S - tail, S // 2][n % 5]
        p = min(max(p, 0), S - 1)
        x[n, p] = max(-2 ** 31, int(x[n].min()) - 1 - n % 70000)
    x[-1, -1] = -2 ** 31
    xt = torch.from_numpy(x.astype(np.int32)).cuda()
    for src in (xt, _off16(xt)):
        for sub, form in ((True, "ptm"), (False, "semi")):
            before = st.frame_best_sub.forms.get(form, 0)
            got = st.frame_best_sub(src, sub)
            assert st.frame_best_sub.forms[form] == before + 1
            want = st.frame_best_sub_plain(src, sub)
            assert got.dtype == torch.int16 and torch.equal(got, want)


# -- K4 and its carry form redesigned: the bounded loop, R rows a launch, the
# frame step's registers and prefetch ---------------------------------------

# (E, P): the shared layout with two phones a thread in registers (the
# long form's P=1,238 at 3 states), with one (5 states, P=200) and with
# none (P=3,000), the global layout with int16 tokens just past the
# switch, and with int32 ones
CHUNK_FORMS = [(3, 1238), (5, 200), (3, 3000), (3, 7041), (5, 4742),
               (3, 11000), (5, 6554)]


@pytest.mark.parametrize("R", [1, 4, 8])
@pytest.mark.parametrize("E,P", CHUNK_FORMS)
def test_viterbi_chunk_rows_equal_plain_on_card(E, P, R):
    """The R-row carry form against its plain version: R rows from
    carries one 16-frame chunk in, frame counts mixed (past the chunk,
    ending inside it, at t0, before t0), tokens into ``out``; one launch
    and one form count per call."""
    _need_cuda()
    rng = np.random.RandomState(P + E + R)
    C, t0, S = 16, 16, E * P
    g = random_graph(P, E, rng, T=t0 + C)
    c = at.graph_consts_from_numpy(g, "cuda")
    sen = torch.from_numpy(rng.randint(0, 4, (R, t0 + C, S))
                           .astype(np.int32)).cuda()
    ns = [t0 + C + 3, t0 + 5, t0, t0 - 4, 2, t0 + C, t0 + 1, 9][:R]
    n = torch.tensor(ns, dtype=torch.int32, device="cuda")
    carry0 = tuple(x.expand(R, *x.shape) for x in at.vit_carry0(c))
    carry, _ = at.viterbi_chunk_rows_plain(sen[:, :t0].contiguous(), carry0,
                                           0, n, c)
    chunk = sen[:, t0:].contiguous()
    want = at.viterbi_chunk_rows_plain(chunk, carry, t0, n, c)
    glob = cuda_build.lib().sst_viterbi_smem_bytes(P, E) > at.MAX_SMEM_BYTES
    form = (f"{E}-state" + (", int32" if S >= 32767 else "")
            + (", global" if glob else ""))
    before = (at.viterbi_chunk.launches, at.viterbi_chunk.forms.get(form, 0))
    out = torch.empty((R, C, S), dtype=at.tok_dtype(S), device="cuda")
    new, tok = at.viterbi_chunk_rows(chunk, carry, t0, n, c, out=out)
    assert tok is out
    _equal((tok,) + tuple(new), (want[1],) + tuple(want[0]))
    assert (at.viterbi_chunk.launches,
            at.viterbi_chunk.forms[form]) == (before[0] + 1, before[1] + 1)


def _padded_graph(P: int, E: int, rng, K: int = 125, T: int = 48) -> dict:
    """random_graph's tables with in-degrees 0..3 padded to K slots (a
    decode graph's shape), and a tenth of the nodes of in-degree 3."""
    g = random_graph(P, E, rng, T=T)
    n = at.pred_count(g["pk"])
    src = np.concatenate([g["pi"][p, :n[p]] for p in range(P)])
    dst = np.repeat(np.arange(P), n)
    pen = np.concatenate([g["pp"][p, :n[p]] for p in range(P)])
    g["pi"], g["pp"], g["pk"] = at.build_pred_table(src, dst, pen, P,
                                                    k_pad=K)
    return g


@pytest.mark.parametrize("case", ["random", "guards"])
@pytest.mark.parametrize("E,P", [(3, 300), (5, 300), (3, 2500), (3, 7041),
                                 (5, 4742)])
def test_viterbi_bounded_loop_equals_plain_on_card(E, P, case):
    """K4 (with and without scores) and the carry form (16-frame chunks,
    then the single-utterance path) with K = 125 padded slots on random
    graphs of in-degree 0..3, shared (a thread's phones in registers, and
    P=2,500 without) and global layouts; "guards" drives a fifth of the
    states below WORST_SCORE, so real slots fall below it and the carry
    form's padded slot must win."""
    _need_cuda()
    rng = np.random.RandomState(P + E + len(case))
    T, S = 48, E * P
    g = _padded_graph(P, E, rng, T=T)
    c = at.graph_consts_from_numpy(g, "cuda")
    assert c.pred_idx.shape[1] == 125 and int(c.pred_n.max()) <= 3
    sen = rng.randint(0, 4000, (3, T, S))
    if case == "guards":
        sen[rng.random_sample(sen.shape) < 0.2] = 0x30000000
    sen = torch.from_numpy(sen.astype(np.int32)).cuda()
    n = torch.tensor([T, T - 5, 2], dtype=torch.int32).cuda()
    for ws in (False, True):
        _equal(at.viterbi_batch(sen, n, c, ws),
               at.viterbi_batch_plain(sen, n, c, ws))
    ck = cp = at.vit_carry0(c)
    for t0 in range(0, T, 16):
        ck, tk = at.viterbi_chunk(sen[0, t0:t0 + 16], ck, t0, T - 5, c)
        cp, tp_ = at.viterbi_chunk_plain(sen[0, t0:t0 + 16], cp, t0, T - 5,
                                         c)
        _equal((tk,) + tuple(ck), (tp_,) + tuple(cp))
    for nn in (T - 5, 2):
        _equal(at.viterbi_single(sen[0], nn, c),
               at.viterbi_single_plain(sen[0], nn, c))


def test_viterbi_batch_register_forms_on_card(cuda_aligner):
    """K4 on the same-transcript route's graphs with one phone a thread
    in registers (the transcript), two (24 repeats, P between 1,024 and
    2,048) and none (40 repeats, shared layout), with and without
    scores: the plain version's bits."""
    al = cuda_aligner
    rng = np.random.RandomState(9)
    for text in (TEXT, " ".join([TEXT] * 24), " ".join([TEXT] * 40)):
        c = al._graph_consts(al.graph_for_text(text))
        sen = torch.from_numpy(rng.randint(0, 3000, (3, 96, c.gs.S))
                               .astype(np.int32)).cuda()
        n = torch.tensor([96, 50, 2], dtype=torch.int32, device="cuda")
        for ws in (False, True):
            _equal(at.viterbi_batch(sen, n, c.vit, ws),
                   at.viterbi_batch_plain(sen, n, c.vit, ws))


# -- K6's bounded loop, registers, prefetch and clusters ---------------------

# (E, P): a graph one block holds at one phone a thread (300), the
# shared-memory limit of one block (7,040 phones of 3 states, 4,741 of
# 5) and one past it, and int32 tokens (S >= 32,767)
ROWS_FORMS = [(3, 300), (5, 300), (3, 7040), (3, 7041), (5, 4741),
              (5, 4742), (3, 11000), (5, 6554)]


def _heavy_graph(P: int, E: int, rng, T: int = 48) -> dict:
    """random_graph's tables plus a few phones of in-degree 9 to 120
    from anywhere in the graph (a decode graph's junctions), which K6
    weighs a warp each."""
    g = random_graph(P, E, rng, T=T)
    n = at.pred_count(g["pk"])
    src = [g["pi"][p, :n[p]] for p in range(P)]
    pen = [g["pp"][p, :n[p]] for p in range(P)]
    for p in rng.choice(P, min(P, 6), replace=False):
        k = rng.randint(9, 121)
        src[p] = np.concatenate([src[p], rng.randint(0, P, k)])
        pen[p] = np.concatenate([pen[p], -rng.randint(0, 4000, k)])
    dst = np.repeat(np.arange(P), [len(x) for x in src])
    g["pi"], g["pp"], g["pk"] = at.build_pred_table(
        np.concatenate(src), dst, np.concatenate(pen), P, k_pad=126)
    return g


@pytest.mark.parametrize("E,P", ROWS_FORMS)
def test_viterbi_rows_clusters_equal_plain_on_card(E, P):
    """K6 on random stacks of three rows, K-slot (cyclic, in-degree 0..3
    with a few phones of 9 to 120, padded to K = 126) and band (forward
    edges, W = 8) lists, with and without scores, at the launcher's
    choice and at clusters of 1, 8 and 16 blocks a row (16 where the
    card can run it; 1 past one block's shared memory is the
    global-memory layout): every output equal to the plain version,
    each launch counted at its layout."""
    _need_cuda()
    rng = np.random.RandomState(P + 10 * E)
    T, S = 40, E * P
    kg = [_heavy_graph(P, E, rng, T=T) for _ in range(3)]
    stacks = {"K-slot": stack_random(kg),
              "band": stack_random([random_graph(P, E, rng, T=T,
                                                 cyclic=False)
                                    for _ in range(3)], band_w=8)}
    sen = rng.randint(0, 4000, (3, T, S))
    sen[rng.random_sample(sen.shape) < 0.1] = 0x30000000   # below WORST
    sen = torch.from_numpy(sen.astype(np.int32)).cuda()
    n = torch.tensor([T, T - 5, 2], dtype=torch.int32).cuda()
    ran = set()
    for table, st_ in stacks.items():
        rc = at.row_consts_from_numpy(st_, "cuda")
        assert rc.lists()[0] == table
        for ws in (False, True):
            want = at.viterbi_rows_plain(sen, n, rc, ws)
            for cluster in (0, 1, 8, 16):
                try:
                    cs = at.rows_layout(P, E, S, ws, cluster)
                except ValueError:
                    assert cluster == 16, (table, ws, cluster)
                    continue
                before = dict(at.viterbi_rows.layouts)
                _equal(at.viterbi_rows(sen, n, rc, ws, cluster), want)
                key = at.layout_name(cs)
                assert at.viterbi_rows.layouts[key] == before.get(key, 0) + 1
                ran.add((cluster, cs))
    assert {c for c, _ in ran} >= {0, 1, 8}
    # one block where it holds the row at two phones a thread; past that,
    # a cluster; one block asked for past its shared memory: global memory
    auto = dict(ran)[0]
    assert (auto == 1) == (P <= 2048)
    glob = cuda_build.lib().sst_viterbi_smem_bytes(P, E) > at.MAX_SMEM_BYTES
    assert (dict(ran)[1] == 0) == glob


# -- K4's carry form on a thread-block cluster --------------------------------

# (E, P): one block (up to 2,048 phones at two a thread), the smallest
# clusters past it at 3 and 5 states, and int32 tokens (S >= 32,767)
CHUNK_CLUSTER_FORMS = [(3, 1238), (5, 300), (3, 3000), (5, 2500),
                       (3, 11000), (5, 6554)]


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("E,P", CHUNK_CLUSTER_FORMS)
def test_viterbi_chunk_clusters_equal_plain_on_card(E, P, R):
    """K4's carry form on random graphs with phones of no predecessor and
    a few of 9 to 120 (weighed a warp each in a cluster), a tenth of the
    scores at 0x30000000 (real slots fall below WORST_SCORE, so the
    padded slot must win), at the launcher's choice, at one block and at
    clusters of 2, 8 and 16 (where they hold the row; 16 where the card
    can run it; one block past its shared memory is the global-memory
    layout): a 16-frame chunk from a carried state at t0 = 16, rows'
    frame counts past the chunk, inside it and before t0, then each
    row's single-utterance path with its final select and backtrace;
    the plain version's bits in every layout, each launch counted at
    its layout."""
    _need_cuda()
    rng = np.random.RandomState(P + 10 * E + R)
    C, t0, S = 16, 16, E * P
    T = t0 + C
    c = at.graph_consts_from_numpy(_heavy_graph(P, E, rng, T=T), "cuda")
    assert int(c.pred_n.min()) == 0 and int(c.pred_n.max()) > 8
    sen = rng.randint(0, 4000, (R, T, S))
    sen[rng.random_sample(sen.shape) < 0.1] = 0x30000000   # below WORST
    sen = torch.from_numpy(sen.astype(np.int32)).cuda()
    ns = [t0 + 5] if R == 1 else [T + 3, t0 + 5, t0 - 4]
    n = torch.tensor(ns, dtype=torch.int32, device="cuda")
    carry0 = tuple(x.expand(R, *x.shape) for x in at.vit_carry0(c))
    carry, _ = at.viterbi_chunk_rows_plain(sen[:, :t0].contiguous(), carry0,
                                           0, n, c)
    chunk = sen[:, t0:].contiguous()
    want = at.viterbi_chunk_rows_plain(chunk, carry, t0, n, c)
    singles = [at.viterbi_single_plain(sen[r], min(ns[r], T), c)
               for r in range(R)]
    ran = {}
    for cluster in (0, 1, 2, 8, 16):
        try:
            cs = at.chunk_layout(P, E, S, cluster)
        except ValueError:
            assert cluster == 16 or -(-P // cluster) > 2048, cluster
            continue
        key = at.layout_name(cs)
        before = at.viterbi_chunk.layouts.get(key, 0)
        new, tok = at.viterbi_chunk_rows(chunk, carry, t0, n, c,
                                         cluster=cluster)
        _equal((tok,) + tuple(new), (want[1],) + tuple(want[0]))
        for r in range(R):
            _equal(at.viterbi_single(sen[r], min(ns[r], T), c, cluster),
                   singles[r])
        assert at.viterbi_chunk.layouts[key] == before + 1 + R
        ran[cluster] = cs
    assert {0, 1, 8} <= set(ran)
    # one block where it holds the row at two phones a thread, else the
    # smallest cluster whose ranks hold at most 512 phones, or 16 (R of
    # them resident at once); one block asked for past its shared
    # memory: global memory
    want = 1 if P <= 2048 else next(
        cs for cs in (2, 4, 8, 16) if cs == 16 or -(-P // cs) <= 512)
    assert ran[0] == want
    glob = cuda_build.lib().sst_viterbi_smem_bytes(P, E) > at.MAX_SMEM_BYTES
    assert (ran[1] == 0) == glob


def _random_scorer(Cu: int, F: int, D: int, L: int, topn: int, rng):
    """A GraphScorer of random float32 tables (its mixture weights unused
    here), densities 1 and 2 copies of density 0 (ties)."""
    means = rng.standard_normal((Cu, F, D, L)).astype(np.float32)
    var_t = rng.uniform(0.5, 3.0, (Cu, F, D, L)).astype(np.float32)
    det = rng.uniform(-3e3, 3e3, (Cu, F, D)).astype(np.float32)
    for a in (means, var_t, det):
        a[:, :, 1:3] = a[:, :, :1]
    muv, c = st.mxu_constants(means, var_t)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    return st.GraphScorer(
        means=dev(means), var_t=dev(var_t), det=dev(det),
        mixw=torch.zeros((F, D, 1), dtype=torch.uint8, device="cuda"),
        cb_pos=torch.zeros(1, dtype=torch.int32, device="cuda"),
        logadd=torch.zeros(1, dtype=torch.int32, device="cuda"),
        muv=dev(muv), c=dev(c), topn=topn)


def _tile_frames(F: int) -> list:
    """Frame counts that leave a tile remainder (1, 37, 1,001) and, on
    this card, the first N past each step of sst_dist_topn_tile's rule
    (tiles of 32 and of 64 from two blocks an SM), each one frame past a
    whole tile."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return [1, 37, 1001] + [tile * -(-2 * sms // F) + 1 for tile in (32, 64)]


@pytest.mark.parametrize("D,L", [(128, 13), (96, 13), (32, 13), (7, 13),
                                 (128, 8)])
def test_dist_topn_tiles_equal_plain_on_card(D, L):
    """K2 (fold and mxu) against its plain version at frame counts that
    leave a tile remainder, at each of the launcher's tiles (16, 32 and
    64, chosen by N), top-N 1 to 8 (at most D), D below a warp and
    between warps, L = 13 (the model rows in registers) and L = 8 (read
    from shared memory); frames whose distances clamp at INT_MIN."""
    _need_cuda()
    rng = np.random.RandomState(D + L)
    tiles = set()
    for N in _tile_frames(3):
        feats = rng.standard_normal((N, 3, L)).astype(np.float32) * 4
        feats[0] = 1e5
        x = torch.from_numpy(feats).cuda()
        tile = cuda_build.lib().sst_dist_topn_tile(N, 3)
        assert N % tile, (N, tile)
        tiles.add(tile)
        for topn in range(1, min(8, D) + 1):
            gs = _random_scorer(5, 3, D, L, topn, rng)
            for mode in ("fold", "mxu"):
                want = st.dist_topn_norm_plain(x, gs, mode)
                before = st.dist_topn_norm.tiles.get(tile, 0)
                got = st.dist_topn_norm(x, gs, mode)
                assert st.dist_topn_norm.tiles[tile] == before + 1
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (N, topn, mode, tile)
    assert tiles == {16, 32, 64}


def _random_ms(C: int, F: int, D: int, L: int, S: int, topn: int, rng,
               aw: int = 1) -> st.MsScorer:
    """An ms scorer on the card of random float32 tables and weights:
    densities 1 and 2 copies of density 0 (ties), densities 3 and 4 one
    mean (``ZERO_MEAN``) with det -0.0 and +0.0 (distances -0.0 and +0.0
    at a frame on that mean), every other det negative; S senones on C
    codebooks (senone s on codebook s where C == S, the 1:1 map); the
    8-bit table of base 1.0001 (256 entries) and its zero."""
    from soundswallower_tpu_torch.logmath import SENSCR_SHIFT, LogMath
    means = rng.standard_normal((C, F, D, L)).astype(np.float32)
    var_t = rng.uniform(0.5, 3.0, (C, F, D, L)).astype(np.float32)
    det = rng.uniform(-3e3, -1.0, (C, F, D)).astype(np.float32)
    for a in (means, var_t, det):
        a[:, :, 1:3] = a[:, :, :1]
    if D >= 5:
        means[:, :, 3:5] = ZERO_MEAN
        det[:, :, 3] = -0.0
        det[:, :, 4] = 0.0
    sen2cb = np.arange(S) if C == S else rng.randint(0, C, S)
    mixw = rng.randint(0, 256, (S, F, D))
    lm = LogMath(1.0001, SENSCR_SHIFT, True)
    return st.ms_scorer_from_numpy(means, var_t, det, mixw, sen2cb,
                                   np.asarray(lm.table, np.int32), lm.zero,
                                   aw, topn, "cuda")


ZERO_MEAN = np.float32(0.25)


def _k11_frames(N: int, F: int, L: int, rng) -> torch.Tensor:
    """Random frames on the card: frame 0 past every distance's floor,
    frame 1 partly, frame 2 on ZERO_MEAN (the signed zeros)."""
    f = (rng.standard_normal((N, F, L)) * 2).astype(np.float32)
    f[0] = 1e5
    if N > 1:
        f[1, :, :4] = 3e3
    if N > 2:
        f[2] = ZERO_MEAN
    return torch.from_numpy(f).cuda()


@pytest.mark.parametrize("D", [7, 100, 128])
def test_ms_dist_topn_tiles_equal_plain_on_card(D):
    """K11 against its plain version at frame counts that leave a tile
    remainder and at each of the launcher's tiles (16, 32 and 64, chosen
    by N), C = 1, 42 and 1:1 (C = S = 64), top-N 1, 4, 8 and D (every
    density in index order); ties (the later density first), the floor
    (frame 0: (WORST_DIST, 0)), -0.0 below +0.0 (frame 2)."""
    _need_cuda()
    rng = np.random.RandomState(D)
    tiles = set()
    for N in _tile_frames(3):
        x = _k11_frames(N, 3, 13, rng)
        tile = cuda_build.lib().sst_dist_topn_tile(N, 3)
        assert N % tile, (N, tile)
        tiles.add(tile)
        for C in (1, 42, 64):
            for topn in sorted({1, 4, 8, D}):
                ms = _random_ms(C, 3, D, 13, C if C == 64 else 200, topn,
                                rng)
                before = ms_dist_topn_shapes()
                got = st.ms_dist_topn(x, ms)
                want = st.ms_dist_topn_plain(x, ms)
                assert ms_dist_topn_shapes() == before + 1
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (N, C, topn, tile)
                dval, cw = got
                if topn < D:
                    assert bool((dval[0] == st.WORST_DIST).all()
                                and (cw[0] == 0).all())
                    if N > 2 and D >= 5:
                        # +0.0 first, then -0.0; ties: density 2 first
                        assert bool((cw[2, :, :, 0] == 4).all())
                        if topn > 1:
                            assert bool((cw[2, :, :, 1] == 3).all())
                            z = dval[2, :, :, :2].view(torch.int32)
                            assert bool((z[..., 0] == 0).all()
                                        and (z[..., 1] == -2 ** 31).all())
                    # equal distances (densities 0-2): the later first
                    for a, b in ((0, 1), (1, 2), (0, 2)):
                        assert not bool(((cw[..., :-1] == a)
                                         & (cw[..., 1:] == b)).any())
                else:
                    assert bool((cw == torch.arange(
                        D, dtype=torch.int32, device="cuda")).all())
    assert tiles == {16, 32, 64}


def ms_dist_topn_shapes() -> int:
    return sum(st.ms_dist_topn.shapes.values())


def _k12_inputs(N: int, C: int, F: int, n: int, D: int, rng):
    """K12's inputs on the card: random top-N distances and densities,
    and frames that reach the floor (0), the first zero guard (1: the
    first term at or below zero8), the second (2: a later term), the
    table's end (3: terms 0-600 table steps apart), the lower int16 clamp
    for some codebooks beside the upper for the others (4, then the
    clamp after the best's subtraction), the top of the int32 range (5)
    and a distance past it (6: that tile takes int64)."""
    dv = rng.uniform(-4e5, 1e4, (N, C, F, n)).astype(np.float32)
    rows = [np.float32(-2 ** 31) * np.float32(1.5), None, None, None, None,
            2147482000.0, 3e9]
    for i, v in enumerate(rows[:N]):
        if v is not None:
            dv[i] = v
    if N > 1:
        dv[1, ..., 0] = -6e8
    if N > 2 and n > 1:
        dv[2, ..., 1:] = -6e8
    if N > 3:
        dv[3] = -1e5 + rng.randint(0, 600, (C, F, n)) * 1024.0
    if N > 4:
        dv[4] = -4e7
        dv[4, :C // 2 + 1, 0] = 3e8
    if N > 6:
        dv[6, :, :, 1:] = -1e3
    cw = rng.randint(0, D, (N, C, F, n)).astype(np.int32)
    return (torch.from_numpy(dv).cuda(), torch.from_numpy(cw).cuda())


@pytest.mark.parametrize("C,S,D", [(1, 1000, 7), (42, 5126, 128),
                                   (42, 1000, 100), (203, 203, 128)])
def test_ms_senone_eval_groups_equal_plain_on_card(C, S, D):
    """K12 against its plain version: one codebook, 42 (en-us's count) at
    S = 5,126 and 1,000 (neither a multiple of the group of 128), the
    1:1 map (groups of 8 senones, 8 codebooks); D 7, 100, 128; top-N 1,
    4, 8 and D; aw 1, 2, 3; every frame tile (16 to 128, and the small
    tiles of a large top-N) with remainders; the floor, both zero guards,
    table-edge differences, both int16 clamps, the top of the int32
    range and a distance past it."""
    _need_cuda()
    rng = np.random.RandomState(C + S + D)
    lib = cuda_build.lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = set()
    for topn in sorted({1, 4, 8, D}):
        for aw in (1, 2, 3):
            ms = _random_ms(C, 3, D, 13, S, topn, rng, aw)
            g = st.ms_groups(ms)
            assert S % g.G and (g.G, g.U) == ((8, 8) if C == S else
                                              (128, 1 if C == 1 else g.U))
            Ns = [1, 7, 37]
            if topn <= 8 and aw == 1:
                # the first N of each tile of 32 to 128, one frame past a
                # whole tile
                Ns += [t * -(-2 * sms // g.gcb.shape[0]) + 1
                       for t in (32, 64, 128)]
            for N in Ns:
                tile = lib.sst_ms_senone_eval_tile(N, S, g.G, g.U, 3, topn)
                tiles.add(tile)
                dval, cw = _k12_inputs(N, C, 3, ms.n_best, D, rng)
                got = st.ms_senone_eval(dval, cw, ms)
                want = st.ms_senone_eval_plain(dval, cw, ms)
                assert torch.equal(got, want), (topn, aw, N, tile)
                if N > 4 and aw == 1 and C > 1:
                    assert bool((want[4] == 32767).any())
    assert {16, 32, 64, 128} <= tiles or C == S


# K5's edge shapes (B, T, Sx, S, dtype, source and output 4 bytes off a
# 16-byte boundary): S not a multiple of 4 or of a warp, T not a multiple
# of the block's 8 frames, the union route's 2 KB int32 frames, the dense
# route's int16 frames, columns past one block's 1,024 threads, one column
GATHER_CASES = [(3, 7, 50, 21, torch.int32, False),
                (2, 70, 512, 288, torch.int32, False),
                (2, 70, 512, 289, torch.int32, True),
                (2, 33, 5126, 290, torch.int16, False),
                (3, 41, 96, 37, torch.int16, True),
                (1, 65, 64, 2053, torch.int16, False),
                (2, 17, 8, 1, torch.int32, False)]


def _gather_inputs(B, T, Sx, S, dtype, off, rng):
    """A seeded source and columns with every wrap and past-the-end
    case (-1, -Sx, Sx - 1, Sx, -Sx - 1, Sx + 5), on the card; with
    ``off`` the source and the output a 4-byte element past an aligned
    start."""
    info = torch.iinfo(dtype)
    k = 4 // torch.tensor([], dtype=dtype).element_size() if off else 0
    buf = torch.from_numpy(rng.randint(info.min, info.max + 1,
                                       B * T * Sx + k).astype(
        np.int16 if dtype == torch.int16 else np.int32)).cuda()
    src = buf[k:].view(B, T, Sx)
    cols = rng.randint(-Sx, Sx, (B, S)).astype(np.int32)
    edge = [-1, -Sx, Sx - 1, Sx, -Sx - 1, Sx + 5]
    cols[:, :min(S, 6)] = edge[:min(S, 6)]
    out = torch.empty(B * T * S + int(off), dtype=torch.int32,
                      device="cuda")[int(off):].view(B, T, S)
    return src, torch.from_numpy(cols).cuda(), out


@pytest.mark.parametrize("case", GATHER_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}-S{c[3]}-"
                         f"{str(c[4])[6:]}{'-off' if c[5] else ''}")
def test_gather_cols_equals_plain_on_card(case):
    """K5 on each edge shape is bit-equal to gather_cols_plain, in a
    fresh and in a given output (4 bytes off a 16-byte boundary where
    the case says), and its launch is gather_cols_layout's."""
    import ctypes

    _need_cuda()
    B, T, Sx, S, dtype, off = case
    rng = np.random.RandomState(B * T + S)
    src, cols, out = _gather_inputs(B, T, Sx, S, dtype, off, rng)
    want = st.gather_cols_plain(src, cols)
    lay = (ctypes.c_int32 * 2)()
    cuda_build.check(cuda_build.lib().sst_gather_cols_layout(
        S, ctypes.addressof(lay)), "gather_cols_layout")
    py = st.gather_cols_layout(B, T, S)
    assert (lay[0], lay[1]) == (py["threads"], py["frames"])
    assert torch.equal(st.gather_cols(src, cols), want)
    out.fill_(7)
    assert st.gather_cols(src, cols, out) is out
    assert torch.equal(out, want)


# -- the fully continuous model of one 39-dim stream -----------------------

@pytest.mark.parametrize("L,form", [(39, 0), (13, 13), (13, 0)],
                         ids=["39 dims", "13 dims, registers 13",
                              "13 dims, runtime L"])
@pytest.mark.parametrize("D", [32, 7, 100])
def test_ms_dist_topn_parts_equal_plain_on_card(L, form, D):
    """K11 at one stream of 39 dims (the runtime-L form) and of 13 (in
    both forms) against its plain version: frame counts with tile
    remainders, C = 1, 42 and a codebook a senone (C = S = 300), the
    codebooks in 1, 3 and 7 forced parts and the launcher's, top-N 1, 4,
    8 and D (a lane ranking one density up to D = 32, four past it); the
    floor (frame 0).  The register form is refused at 39 dims."""
    _need_cuda()
    rng = np.random.RandomState(D + L + form)
    for N in (1, 37, 1001):
        x = _k11_frames(N, 1, L, rng)
        for C in (1, 42, 300):
            for topn in sorted({1, 4, 8, D}):
                ms = _random_ms(C, 1, D, L, C if C == 300 else 200, topn,
                                rng)
                want = st.ms_dist_topn_plain(x, ms)
                for parts in (1, 3, 7):
                    before = st.ms_dist_topn.forms.get(st.MS_FORMS[form], 0)
                    got = st.ms_dist_topn(x, ms, form=form, parts=parts)
                    assert st.ms_dist_topn.forms[st.MS_FORMS[form]] \
                        == before + 1
                    assert all(torch.equal(a, b) for a, b in
                               zip(got, want)), (N, C, topn, parts)
                got = st.ms_dist_topn(x, ms)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                if topn < D:
                    assert bool((got[0][0] == st.WORST_DIST).all())
    if L == 39:
        with pytest.raises(RuntimeError):
            st.ms_dist_topn(x, ms, form=13)


def test_ms_dist_topn_layout_splits_codebooks_on_card():
    """The launcher keeps K2's tile and one part for the 3-stream models
    (42 codebooks) and at large N; a codebook a senone on a bounded
    block splits into parts of at least 64 codebooks, tiles of 64, and
    takes the runtime-L form at 39 dims where the frame form does not
    (a top 9); the runtime-L form's split launch equals the plain version
    at 5,126 codebooks."""
    _need_cuda()
    lib = cuda_build.lib()
    assert st.ms_dist_topn_layout(40960, 42, 3, 13, 128, 4) == (
        lib.sst_dist_topn_tile(40960, 3), 1, 13)
    tile, parts, form = st.ms_dist_topn_layout(2048, 5126, 1, 39, 32, 9)
    assert (tile, form) == (64, 0) and 1 < parts <= 5126 // 64
    assert st.ms_dist_topn_layout(2048, 5126, 1, 7, 32, 4)[2] == 0
    assert st.ms_dist_topn_layout(1 << 22, 5126, 1, 39, 32, 4)[1] == 1
    rng = np.random.RandomState(5)
    ms = _random_ms(5126, 1, 32, 39, 5126, 4, rng)
    x = _k11_frames(70, 1, 39, rng)
    got = st.ms_dist_topn(x, ms, form=0)
    want = st.ms_dist_topn_plain(x, ms)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _floor_from(ms, d0: int):
    """ms with every density from d0 on below WORST_DIST at any frame
    (det -3e9)."""
    det = ms.det.clone()
    det[:, :, d0:] = -3e9
    return dataclasses.replace(ms, det=det)


@pytest.mark.parametrize("D", [32, 20])
def test_ms_dist_topn_frame_form_equals_plain_on_card(D):
    """K11's frame form at one stream of 39 dims, forced (the launcher's
    split and 1, 3 and 7 parts) and by the launcher's choice, equals its
    plain version and the runtime-L form bit for bit (dval's bits and
    cw): N of 1, 63, 65 and 13,057 (off every tile), C = 300 (a codebook
    a senone) and 42, top-N 1, 4, 8 and D (every density in index
    order); densities 1 and 2 copies of density 0 (ties to the later),
    -0.0 below +0.0, frame 0 and, at top 8, the densities from 5 on
    below WORST_DIST ((WORST_DIST, 0) past the five)."""
    _need_cuda()
    rng = np.random.RandomState(100 + D)
    frame = st.MS_FORMS[st.MS_FRAME_FORM]
    for N, C in ((1, 300), (63, 300), (65, 300), (13057, 42)):
        x = _k11_frames(N, 1, 39, rng)
        for topn in sorted({1, 4, 8, D}):
            ms = _random_ms(C, 1, D, 39, C if C == 300 else 200, topn, rng)
            cases = [ms, _floor_from(ms, 5)] if topn == 8 else [ms]
            for sc in cases:
                want = st.ms_dist_topn_plain(x, sc)
                assert _bits_equal(st.ms_dist_topn(x, sc, form=0), want)
                before = st.ms_dist_topn.forms.get(frame, 0)
                for parts in (0, 1, 3, 7):
                    got = st.ms_dist_topn(x, sc, form=st.MS_FRAME_FORM,
                                          parts=parts)
                    assert _bits_equal(got, want), (N, C, topn, parts)
                got = st.ms_dist_topn(x, sc)
                assert st.ms_dist_topn.forms[frame] == before + 5
                assert _bits_equal(got, want), (N, C, topn)
                dval, cw = got
                if topn == D:
                    assert bool((cw == torch.arange(
                        D, dtype=torch.int32, device="cuda")).all())
                    continue
                assert bool((dval[0] == st.WORST_DIST).all()
                            and (cw[0] == 0).all())
                if sc is not ms:
                    assert bool((dval[:, :, :, 5:] == st.WORST_DIST).all()
                                and (cw[:, :, :, 5:] == 0).all()
                                and (cw[1:, :, :, :5] < 5).all())
                    continue
                if N > 2:
                    assert bool((cw[2, :, :, 0] == 4).all())
                for a, b in ((0, 1), (1, 2), (0, 2)):
                    assert not bool(((cw[..., :-1] == a)
                                     & (cw[..., 1:] == b)).any())


def test_ms_dist_topn_frame_layout_on_card():
    """The launcher takes the frame form at 39 dims with a top N of at
    most 8 or every density, else 13 at 13 dims, else runtime L, and the
    wrapper counts the form it took; the frame form's tile is 512
    frames, and a story block of 13,056 frames splits the 5,126
    codebooks into parts of at least 8; no frames (and no codebooks)
    give a layout and an empty launch; a forced frame form at 13 dims
    and at a top 9 raises."""
    _need_cuda()
    frame = st.MS_FRAME_FORM
    for D, L, ne, want in ((32, 39, 4, frame), (32, 39, 1, frame),
                           (32, 39, 2, frame), (32, 39, 8, frame),
                           (32, 39, 32, frame), (20, 39, 20, frame),
                           (32, 39, 9, 0), (100, 39, 4, frame),
                           (128, 13, 4, 13), (32, 7, 4, 0)):
        form = st.ms_dist_topn_layout(13056, 5126, 1, L, D, ne)[2]
        assert form == want, (D, L, ne)
        assert want in st.ms_dist_topn_forms(D, L, ne)
    tile, parts, form = st.ms_dist_topn_layout(13056, 5126, 1, 39, 32, 4)
    assert (tile, form) == (512, frame)
    assert 1 < parts <= 5126 // 8
    assert st.ms_dist_topn_layout(1 << 22, 5126, 1, 39, 32, 4)[1] == 1
    for N, C in ((0, 5126), (0, 0), (70, 0)):
        assert st.ms_dist_topn_layout(N, C, 1, 39, 32, 4)[2] == frame
    rng = np.random.RandomState(9)
    ms = _random_ms(42, 1, 32, 39, 200, 4, rng)
    for form in (None, frame, 0):
        counted = dict(st.ms_dist_topn.forms)
        x = torch.zeros((0, 1, 39), dtype=torch.float32, device="cuda")
        dval, cw = st.ms_dist_topn(x, ms, form)
        assert dval.shape == cw.shape == (0, 42, 1, 4)
        name = st.MS_FORMS[frame if form is None else form]
        assert st.ms_dist_topn.forms[name] == counted.get(name, 0) + 1
    rng = np.random.RandomState(7)
    x = _k11_frames(70, 1, 13, rng)
    with pytest.raises(RuntimeError):
        st.ms_dist_topn(x, _random_ms(42, 1, 32, 13, 200, 4, rng),
                        form=st.MS_FRAME_FORM)
    x = _k11_frames(70, 1, 39, rng)
    with pytest.raises(RuntimeError):
        st.ms_dist_topn(x, _random_ms(42, 1, 32, 39, 200, 9, rng),
                        form=st.MS_FRAME_FORM)


@pytest.mark.parametrize("D", [100, 7])
def test_ms_dist_topn_frame_form_other_widths_on_card(D):
    """The frame form past a warp of densities (D = 100) and at an odd
    one (D = 7), top 1, 2, 3, 4 and D, forced in 1 and 5 parts, equals
    its plain version bit for bit."""
    _need_cuda()
    rng = np.random.RandomState(200 + D)
    x = _k11_frames(300, 1, 39, rng)
    for topn in sorted({1, 2, 3, 4, D}):
        ms = _random_ms(42, 1, D, 39, 200, topn, rng)
        want = st.ms_dist_topn_plain(x, ms)
        for parts in (1, 5):
            got = st.ms_dist_topn(x, ms, form=st.MS_FRAME_FORM, parts=parts)
            assert _bits_equal(got, want), (topn, parts)


def test_ms_senone_eval_one_codebook_a_senone_on_card():
    """K12 at the continuous model's shape: a codebook a senone (groups
    of 8), S = 5,126, one stream, D = 32, top-N 4, against its plain
    version, written into a given block of an output."""
    _need_cuda()
    rng = np.random.RandomState(12)
    ms = _random_ms(5126, 1, 32, 39, 5126, 4, rng)
    g = st.ms_groups(ms)
    assert (g.G, g.U) == (8, 8)
    for N in (1, 37, 700):
        dval, cw = _k12_inputs(N, 5126, 1, 4, 32, rng)
        want = st.ms_senone_eval_plain(dval, cw, ms)
        out = torch.full((N + 5, 5126), 7, dtype=torch.int16, device="cuda")
        st.ms_senone_eval(dval, cw, ms, out=out[3:3 + N])
        assert torch.equal(out[3:3 + N], want)
        assert bool((out[:3] == 7).all() and (out[3 + N:] == 7).all())


@pytest.mark.parametrize("L", [39, 7])
def test_score_frames_ms_blocks_equal_one_call_on_card(L):
    """score_frames_ms in blocks of 1, 64, 100 and 333 frames (blocks
    that split a 128-frame row) and its default block equal one K11 and
    one K12 call over all the frames."""
    _need_cuda()
    rng = np.random.RandomState(L)
    ms = _random_ms(300, 1, 32, L, 300, 4, rng)
    x = _k11_frames(1000, 1, L, rng)
    dval, cw = st.ms_dist_topn(x, ms)
    want = st.ms_senone_eval(dval, cw, ms)
    for block in (1, 64, 100, 333, None):
        assert torch.equal(st.score_frames_ms(ms, x, block=block), want)


@pytest.mark.parametrize("fe", ["host", "device"])
def test_cont_aligner_equals_plain_reference_on_card(tmp_path_factory, fe,
                                                     monkeypatch):
    """A continuous model of one 39-dim stream through align_batch on
    the card (same and different transcripts) equals the plain reference
    (tests/plain_cont.py, on the card) in segments."""
    _need_cuda()
    from make_synth_model import make_cont_model
    from plain_cont import PlainCont
    from portbench.reference.align import seg_rep

    monkeypatch.setenv("SST_FE", fe)
    d = make_cont_model(str(tmp_path_factory.mktemp("cont")), 0, "small")
    al = TorchAligner(hmm=d, samprate=SAMPRATE, device="cuda")
    assert al.streams == (1, 39) and (al.native_fe is None) == (fe ==
                                                                 "device")
    ref = PlainCont(d, SAMPRATE, host_fe=fe == "host", device="cuda")
    audios = [austen_audio(i) for i in range(6)]
    texts = [TEXT, " ".join(TEXT.split()[:5])] * 3
    for tx in ([TEXT] * 6, texts):
        got = al.align_batch(audios, tx)
        want = ref.align_rows(audios, tx)
        assert [seg_rep(s) for s in got] == [seg_rep(s) for s in want]
