"""K1 (dequant + batch CMN + dynamic features): the port's plain version
against the JAX program, bit-equal."""

import types

import numpy as np
import pytest
import torch

from tests.conftest import golden

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu_torch.fe.feat import feat, feat_plain, feats_plain

torch.set_num_threads(1)


def _planes(seed: int, B: int, T: int, scale: float):
    """Wire byte planes [2, B, T, 13] of round(cep * scale) with c0 < 0 on
    a third of the frames (excluded from the CMN mean)."""
    rng = np.random.RandomState(seed)
    cep = rng.normal(0.0, 6.0, (B, T, 13))
    cep[:, :, 0] = np.where(rng.random_sample((B, T)) < 0.33,
                            -rng.random_sample((B, T)) * 5,
                            5 + rng.random_sample((B, T)) * 20)
    v = np.clip(np.round(cep * scale), -32768, 32767).astype(np.int16)
    u = v.view(np.uint16)
    return np.stack([(u & 0xFF).astype(np.uint8),
                     (u >> 8).astype(np.uint8)])


def _jax_feats(planes, Ts, cmn: str, scale: float):
    """The JAX package's own _feats_chunk_planes on a bare object that
    carries just the attributes it reads."""
    fake = types.SimpleNamespace(config={"cmn": cmn}, wire_scale=scale)
    out = TpuAligner._feats_chunk_planes(fake, planes, Ts, planes.shape[2])
    return np.asarray(out)


@pytest.mark.parametrize("cmn,scale", [("current", 128.0), ("batch", 256.0),
                                       ("live", 128.0)])
def test_feat_plain_matches_jax(cmn, scale):
    T = 64
    planes = _planes(1, 3, T, scale)
    Ts = np.array([T, 17, 40], np.int32)   # a full row, a short row, one mid
    want = _jax_feats(planes, Ts, cmn, scale)
    got = feat_plain(torch.from_numpy(planes), torch.from_numpy(Ts),
                     1.0 / scale, cmn in ("batch", "current")).numpy()
    assert got.dtype == np.float32 and got.shape == (3, T, 3, 13)
    assert (got.view(np.uint32) == want.view(np.uint32)).all()


def test_feat_wrapper_takes_plain_on_cpu():
    planes = torch.from_numpy(_planes(2, 2, 64, 128.0))
    Ts = torch.tensor([64, 30], dtype=torch.int32)
    before = feat.launches
    a = feat(planes, Ts, 1.0 / 128, True)
    assert feat.launches == before   # nothing launched for a CPU tensor
    assert torch.equal(a, feat_plain(planes, Ts, 1.0 / 128, True))


def test_austen_feat_bitexact():
    """The C oracle's cepstra -> its features, bit for bit."""
    cep = golden("austen-en", "mfcc.f32", np.float32, (-1, 13))
    want = golden("austen-en", "feat.f32", np.float32, (-1, 3, 13))
    n = len(cep)
    got = feats_plain(torch.from_numpy(cep)[None],
                      torch.tensor([n], dtype=torch.int32), True)[0].numpy()
    assert (got.view(np.uint32) == want.view(np.uint32)).all()
