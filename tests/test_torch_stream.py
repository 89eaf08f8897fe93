"""The port's AlignStream (plain PyTorch on the CPU) against the JAX
package's, on the small synthetic model: segments, partial results,
state() at cut points (every key, dtype and value), checkpoints
restored across the two packages, and chunk-size invariance on the
port side.  Every comparison is exact."""

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir, segs_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.streaming import AlignStream as JaxStream
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.streaming import AlignStream

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = model_dir(tmp_path_factory, "small")
    return (TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu"),
            TpuAligner(hmm=d, samprate=SAMPRATE))


def _pieces(audio, split):
    return [audio[i:i + split] for i in range(0, len(audio), split)]


def _assert_same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, tuple):
            assert isinstance(y, tuple) and len(x) == len(y), k
            for u, v in zip(x, y):
                u, v = np.asarray(u), np.asarray(v)
                assert u.dtype == v.dtype and u.shape == v.shape, k
                assert np.array_equal(u, v), k
        elif isinstance(x, np.ndarray) or isinstance(x, np.generic):
            assert np.asarray(x).dtype == np.asarray(y).dtype, k
            assert np.asarray(x).shape == np.asarray(y).shape, k
            assert np.array_equal(x, y), k
        else:
            assert type(x) is type(y) and x == y, k


@pytest.mark.parametrize("split", [777, 1600])
def test_stream_equals_reference(small, split):
    """Push the same pieces into both streams: state() at three cut
    points (the second one after the first full Viterbi chunk), partial
    results, and the final segments."""
    port, ref = small
    audio = austen_audio(0)
    pieces = _pieces(audio, split)
    ps, rs = port.stream(TEXT), ref.stream(TEXT)
    cuts = {1, len(pieces) // 2, len(pieces) - 2}
    for k, piece in enumerate(pieces):
        assert ps.push(piece) == rs.push(piece)
        if k in cuts:
            _assert_same_state(ps.state(), rs.state())
            try:
                want = segs_rep(rs.result())
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    ps.result()
            else:
                assert segs_rep(ps.result()) == want
    assert ps._t >= AlignStream.CHUNK
    want = segs_rep(rs.end())
    assert segs_rep(ps.end()) == want
    _assert_same_state(ps.state(), rs.state())


def test_checkpoints_restore_across_packages(small):
    """A JAX checkpoint continues in the port and a port checkpoint in
    the JAX package, each to the same final segments (and state)."""
    port, ref = small
    pieces = _pieces(austen_audio(1), 1600)
    half = len(pieces) // 2
    rs, ps = ref.stream(TEXT), port.stream(TEXT)
    for piece in pieces[:half]:
        rs.push(piece)
        ps.push(piece)
    from_jax = AlignStream.restore(port, rs.state())
    from_port = JaxStream.restore(ref, ps.state())
    for piece in pieces[half:]:
        for s in (rs, ps, from_jax, from_port):
            s.push(piece)
    want = segs_rep(rs.end())
    assert segs_rep(from_jax.end()) == want
    assert segs_rep(from_port.end()) == want
    assert segs_rep(ps.end()) == want
    _assert_same_state(from_jax.state(), rs.state())


def test_port_chunk_size_invariance(small):
    """Whole, 1600-sample and 1-sample-then-4000 pushes give one result;
    a mid-stream restore on the port continues identically."""
    port, _ = small
    audio = austen_audio(2)
    results = []
    for pieces in ([audio], _pieces(audio, 1600),
                   [audio[:1], audio[1:4001], audio[4001:]]):
        s = port.stream(TEXT)
        for p in pieces:
            s.push(p)
        results.append(segs_rep(s.end()))
    assert results[0] == results[1] == results[2]
    s = port.stream(TEXT)
    s.push(audio[:9000])
    r = AlignStream.restore(port, s.state())
    r.push(audio[9000:])
    assert segs_rep(r.end()) == results[0]
    with pytest.raises(RuntimeError):
        r.push(audio[:10])
