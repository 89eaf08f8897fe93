"""K2 (fold + top-N + norm) and K3 (senone eval): the port's plain
versions against the JAX graph-restricted scorer, bit-equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, model_dir
from tests.conftest import golden

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.ops import senscore_jax
from soundswallower_tpu_torch.am import AcousticModel
from soundswallower_tpu_torch.config import Config
from soundswallower_tpu_torch.ops import senscore_torch as st

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_aligner(tmp_path_factory):
    return TpuAligner(hmm=model_dir(tmp_path_factory, "small"),
                      samprate=SAMPRATE)


def _feats(n: int = 256) -> np.ndarray:
    """n frames of the C oracle's austen features; frame 0 is blown up
    so every distance clamps at INT_MIN (ties there), frame 1 so some
    do."""
    f = golden("austen-en", "feat.f32", np.float32, (-1, 3, 13))[:n].copy()
    f[0] = 1e5
    f[1, :, :4] = 3e3
    return f


def _senids(jal, which: str) -> np.ndarray:
    if which == "graph":
        return jal.graph_for_text(TEXT).senid.reshape(-1)
    # 16 used codebooks: the JAX scorer adds its Cu % 8 pad row here
    sen2cb = np.asarray(jal.am.sen2cb)
    return np.nonzero(sen2cb < 16)[0][::2]


def _with_ties(gs):
    """Density 1 a copy of density 0 in every codebook and stream."""
    def dup(a):
        a = np.asarray(a).copy()
        a[:, :, 1] = a[:, :, 0]
        return jnp.asarray(a)

    return dataclasses.replace(gs, means=dup(gs.means), var_t=dup(gs.var_t),
                               det=dup(gs.det))


@pytest.mark.parametrize("which", ["graph", "cu16"])
def test_port_build_equals_jax_tables(jax_aligner, which):
    jal = jax_aligner
    senid = _senids(jal, which)
    gs_j = senscore_jax.GraphScorer.build(jal.am, jal.tables, senid)
    if which == "cu16":
        assert gs_j.means.shape[0] == 17       # the TPU pad row
    cfg = Config(hmm=jal.config["hmm"], samprate=SAMPRATE)
    cfg.expand()
    am = AcousticModel.load(cfg)
    port = st.GraphScorer.build(am, senid, "cpu")
    ref = st.scorer_from_jax_arrays(gs_j)
    for name in ("means", "var_t", "det", "mixw", "cb_pos"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    n = ref.logadd.shape[0]
    assert torch.equal(port.logadd[:n], ref.logadd)
    assert (port.logadd[n:] == 0).all()
    assert (port.topn, port.wrap_u8) == (ref.topn, ref.wrap_u8)


@pytest.mark.parametrize("which", ["graph", "cu16"])
def test_scores_match_jax(jax_aligner, which):
    jal = jax_aligner
    senid = _senids(jal, which)
    gs_j = _with_ties(senscore_jax.GraphScorer.build(jal.am, jal.tables,
                                                     senid))
    feats = _feats()
    want = np.asarray(senscore_jax.score_frames_graph(gs_j, feats))
    gs = st.scorer_from_jax_arrays(gs_j)
    s, cw = st.dist_topn_norm_plain(torch.from_numpy(feats), gs)
    # the clamp and the ties are exercised
    assert (cw[0, :, :, :4] == torch.arange(4, dtype=torch.int32)).all()
    assert bool((cw[2:, :, :, 0] == 0).any() & (cw[2:, :, :, 1] == 1).any())
    got = st.senone_eval_plain(s, cw, gs)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert (got.numpy() == want).all()
    # the wrappers take the plain versions for CPU tensors
    assert torch.equal(st.score_frames_graph(gs, torch.from_numpy(feats)),
                       got)


def test_logadd_table_equals_staircase(jax_aligner):
    tables = jax_aligner.tables
    table = torch.from_numpy(st.logadd_table(jax_aligner.am))
    n = table.shape[0]
    d = np.arange(0, n + 9, dtype=np.int32)
    base = np.full_like(d, 300)
    for x, y in ((base, base + d), (base + d, base)):
        want = np.asarray(senscore_jax._fast_logadd(
            jnp.asarray(x), jnp.asarray(y), tables.table_thresh))
        got = st.logadd_plain(torch.from_numpy(x), torch.from_numpy(y), table)
        assert (got.numpy() == want).all()
