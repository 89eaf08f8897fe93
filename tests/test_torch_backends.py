"""The acoustic-model backends beside 8-bit ptm: 4-bit ptm, semi (8- and
4-bit), ms (senmgau) and ms's 1:1 fallback.  On the small synthetic
models (tools/make_synth_model.py, seed 0), the port's plain path
against the JAX package, bit-equal: the loaded model arrays, the dense
int16 scores and the graph-restricted int32 scores; the ms scorer's
forced cases (a tie between two identical Gaussians, the WORST_DIST
floor, topn >= D, aw = 2); what both packages refuse; the variants'
bytes.  The segments are tests/test_torch_backends_segments.py's."""

import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import (SAMPRATE, TEXT, VARIANTS, austen_audio,
                          make_synth_model, segs_rep, variant_dir)
from tests.conftest import golden

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.am import AcousticModel as JaxAcousticModel
from soundswallower_tpu.ops import senscore_jax as sj
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.am import AcousticModel
from soundswallower_tpu_torch.ops import senscore_torch as st

torch.set_num_threads(1)

SMALL = ["ptm4b", "semi", "semi4b", "ms", "ms1to1"]


@pytest.fixture(scope="module", params=SMALL)
def pair(request, tmp_path_factory):
    d = variant_dir(tmp_path_factory, request.param)
    return (request.param, TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu"),
            TpuAligner(hmm=d, samprate=SAMPRATE))


def _feats(n: int = 96) -> np.ndarray:
    """n frames of the C oracle's austen features; frame 0 blown up so
    that every distance is far out, frame 1 so that some are."""
    f = golden("austen-en", "feat.f32", np.float32, (-1, 3, 13))[:n].copy()
    f[0] = 1e5
    f[1, :, :4] = 3e3
    return f


def test_model_arrays_equal(pair):
    """The port's AcousticModel loads each variant as the JAX one does."""
    variant, port, ref = pair
    a, b = port.am, ref.am
    want_backend = {"ptm4b": "ptm", "semi": "semi", "semi4b": "semi"}.get(
        variant, "ms")
    assert a.backend == b.backend == want_backend
    assert (a.mixw_cb is not None) == variant.endswith("4b")
    for name in ("tmat", "means", "var_t", "det", "mixw", "sen2cb"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (a.mixw_cb is None and b.mixw_cb is None) or np.array_equal(
        a.mixw_cb, b.mixw_cb)
    assert np.array_equal(a.mixw_dense(), b.mixw_dense())
    assert np.array_equal(a.lmath_8b.table, b.lmath_8b.table)
    assert (a.max_topn, a.aw, a.mixw_wrap_u8, a.n_mgau) == \
        (b.max_topn, b.aw, b.mixw_wrap_u8, b.n_mgau)


def test_dense_scores_equal(pair):
    """JAX score_frames + ungroup against the port's full-inventory
    int16 scores (K2/K3/K7 for ptm and semi, K11/K12 for ms), from the
    port's own tables and from the JAX package's."""
    variant, port, ref = pair
    feats = _feats()
    want = sj.ungroup(ref.tables, np.asarray(
        sj.score_frames(ref.tables, jnp.asarray(feats))))
    got = st.score_frames(port.dense, torch.from_numpy(feats)).numpy()
    assert got.dtype == want.dtype == np.int16
    assert np.array_equal(got, want)
    if variant.startswith("ms"):
        assert isinstance(port.dense, st.MsScorer)
        from_jax = st.ms_scorer_from_jax_tables(ref.tables)
    else:
        assert port.dense.subtract_best == (variant == "ptm4b")
        from_jax = st.dense_scorer_from_jax_tables(ref.tables)
    assert np.array_equal(
        st.score_frames(from_jax, torch.from_numpy(feats)).numpy(), want)


def test_graph_scores_equal(pair):
    """JAX score_frames_graph against the port's K2/K3 int32 scores on a
    transcript's graph and on a 100-senone set; ms has no graph scorer
    in either package."""
    variant, port, ref = pair
    g = ref.graph_for_text(TEXT)
    if variant.startswith("ms"):
        with pytest.raises(NotImplementedError):
            sj.GraphScorer.build(ref.am, ref.tables, g.senid)
        with pytest.raises(NotImplementedError):
            st.GraphScorer.build(port.am, g.senid, "cpu")
        return
    feats = _feats()
    for senid in (g.senid.reshape(-1), np.arange(0, ref.am.n_sen, 2)[:100]):
        gs_j = sj.GraphScorer.build(ref.am, ref.tables, senid)
        want = np.asarray(sj.score_frames_graph(gs_j, jnp.asarray(feats)))
        gs = st.GraphScorer.build(port.am, senid, "cpu")
        assert gs.wrap_u8 == (variant == "semi4b")
        got = st.score_frames_graph(gs, torch.from_numpy(feats)).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


MS_CASES = ["tie", "floor", "topn_all", "aw2"]


@pytest.fixture(scope="module")
def ms_tables(tmp_path_factory):
    d = variant_dir(tmp_path_factory, "ms")
    from soundswallower_tpu.config import Config
    cfg = Config(hmm=d, samprate=SAMPRATE)
    cfg.expand()
    return sj.ScorerTables.from_am(JaxAcousticModel.load(cfg))


def _forced(tables, case: str):
    """The ms tables with one of ms_gauden.c's edge cases forced."""
    def rows(a, fn):
        a = np.asarray(a).copy()
        fn(a)
        return jnp.asarray(a)

    if case == "tie":          # density 1 a copy of density 0
        def dup(a):
            a[:, :, 1] = a[:, :, 0]
        return dataclasses.replace(tables, means=rows(tables.means, dup),
                                   var_t=rows(tables.var_t, dup),
                                   det=rows(tables.det, dup))
    if case == "floor":        # all but two densities below WORST_DIST
        def huge(a):
            a[:, :, 2:] = 1e9
        return dataclasses.replace(tables, var_t=rows(tables.var_t, huge))
    if case == "topn_all":
        return dataclasses.replace(tables, max_topn=tables.det.shape[2])
    return dataclasses.replace(tables, aw=2)


@pytest.mark.parametrize("case", MS_CASES)
def test_ms_forced_cases(ms_tables, case):
    tables = _forced(ms_tables, case)
    feats = _feats(48)
    want = sj.ungroup(tables, np.asarray(
        sj.score_frames(tables, jnp.asarray(feats))))
    ms = st.ms_scorer_from_jax_tables(tables)
    dval, cw = st.ms_dist_topn_plain(torch.from_numpy(feats), ms)
    D = ms.det.shape[2]
    if case == "tie":
        # equal distances: the later density first
        hit = (cw[..., :-1] == 1) & (cw[..., 1:] == 0)
        assert bool(hit.any()) and not bool(
            ((cw[..., :-1] == 0) & (cw[..., 1:] == 1)).any())
    elif case == "floor":
        assert bool(((dval == st.WORST_DIST) & (cw == 0)).any())
    elif case == "topn_all":
        assert cw.shape[-1] == D and bool(
            (cw == torch.arange(D, dtype=torch.int32)).all())
    else:
        assert ms.aw == 2
    got = st.ms_senone_eval_plain(dval, cw, ms).numpy()
    assert got.dtype == np.int16 and np.array_equal(got, want)


def test_ms_align_and_stream_raise_on_device_fe(tmp_path_factory,
                                                monkeypatch):
    """Neither package has a graph-restricted ms scorer: on the device
    front end, align and stream raise NotImplementedError in both."""
    d = variant_dir(tmp_path_factory, "ms")
    monkeypatch.setenv("SST_FE", "device")
    port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=d, samprate=SAMPRATE)
    assert port.native_fe is None and ref.native_fe is None
    a = austen_audio(0)
    for al in (port, ref):
        with pytest.raises(NotImplementedError):
            al.align(a, TEXT)
        with pytest.raises(NotImplementedError):
            al.stream(TEXT).push(a)
    # the batch routes run on the device front end
    want = [segs_rep(s) for s in ref.align_batch([a], [TEXT])]
    assert [segs_rep(s) for s in port.align_batch([a], [TEXT])] == want


@pytest.mark.parametrize("variant", ["ptm4b", "semi4b"])
def test_device_fe_align_and_stream_equal(tmp_path_factory, monkeypatch,
                                          variant):
    """4-bit ptm and 4-bit semi (wrap_u8) on the device front end: the
    single-utterance align and a stream in 1600-sample pieces run the
    graph-restricted scorer, and give TpuAligner's segments."""
    d = variant_dir(tmp_path_factory, variant)
    monkeypatch.setenv("SST_FE", "device")
    port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=d, samprate=SAMPRATE)
    a = austen_audio(2)
    assert segs_rep(port.align(a, TEXT)) == segs_rep(ref.align(a, TEXT))
    ps, rs = port.stream(TEXT), ref.stream(TEXT)
    for i in range(0, len(a), 1600):
        ps.push(a[i:i + 1600])
        rs.push(a[i:i + 1600])
    assert segs_rep(ps.end()) == segs_rep(rs.end())


VARIANT_SHA256 = {
    ("small", "ptm4b"):
        "c6d1f9fd96e379b7a2cfaa849506548f03e77ff0d847e0fd12ef7ccb092ce4e2",
    ("small", "semi"):
        "0a1739856f233b68f029bd057a2b1d4f3162a5cb404d2665fd63e588c884fa66",
    ("small", "semi4b"):
        "a07bd6c906ae1f4cbebb617e83463c2518a9d8c5df96c97afa9aee8e708fe411",
    ("small", "ms"):
        "6949d7bf4872d32b9eea0e42891ba982dd167855f505b1a633727de90a80adca",
    ("small", "ms1to1"):
        "2ece94c2917a06b2af70754b1ca45ad020e6fec161840c2dc86f8723c99afb9c",
    ("en-us", "ptm4b"):
        "1f4e5298c49307dd2b828a2c6ecba489ead17cbbb5271cf2b267973f8d3cf429",
    ("en-us", "semi"):
        "5f07a429d7d43a38e301351343f338f0c9429610462a3689eca4626e440b667e",
    ("en-us", "semi4b"):
        "069760d978e077a71b854e9d17cdf5f603061d2d931fd8aa247729240fc1d98f",
    ("en-us", "ms"):
        "0bc3c8cb540097381c0f4b4bda80b26843c0a5a44fba6d37903550767d6696b2",
}


@pytest.mark.parametrize("width,variant", sorted(VARIANT_SHA256),
                         ids=lambda x: x)
def test_synth_variant_bytes_pinned(tmp_path, width, variant):
    backend, bits = VARIANTS[variant]
    d = make_synth_model(str(tmp_path), 0, width, backend, bits)
    h = hashlib.sha256()
    for name in sorted(os.listdir(d)):
        h.update(name.encode())
        with open(os.path.join(d, name), "rb") as fh:
            h.update(fh.read())
    assert h.hexdigest() == VARIANT_SHA256[width, variant]


def test_writer_refuses_unknown_combinations(tmp_path):
    with pytest.raises(ValueError):
        make_synth_model(str(tmp_path), 0, "small", "ms", 4)
    with pytest.raises(ValueError):
        make_synth_model(str(tmp_path), 0, "small", "cont", 8)
