"""The span and counter recorder (``soundswallower_tpu_torch.spans``) in
TorchAligner (plain PyTorch on the CPU, the small synthetic model): off,
it records and allocates nothing; on, the batch and long-form entry
points record their named span trees under one request a call, the
host front end's worker spans carry their request, the frame counters
count the real and the scored frames, and the segments are the same as
with nothing installed."""

import threading
import tracemalloc

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir, segs_rep

from soundswallower_tpu_torch import spans
from soundswallower_tpu_torch.aligner import TorchAligner

torch.set_num_threads(1)

TEXTS = [TEXT, "young man", "he was not", "an ill man", "was not young"]

BEGIN = {"graphs", "union", "stack", "consts", "pack", "fe.wait",
         "fe.device", "score", "gather", "viterbi", "download"}
END = {"wait", "extract", "segs"}
LONGFORM = {"graphs", "consts", "pack", "fe.wait", "fe.device", "score",
            "viterbi", "backtrace", "wait", "extract"}


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


@pytest.fixture(scope="module")
def ports(small_dir):
    """The aligner on the host front end (its worker thread) and on the
    device one (K8-K10's plain versions)."""
    out = {}
    for fe in ("host", "device"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SST_FE", fe)
            out[fe] = TorchAligner(hmm=small_dir, samprate=SAMPRATE,
                                   device="cpu")
        assert (out[fe].native_fe is None) == (fe == "device")
    return out


@pytest.fixture(params=["host", "device"])
def port(request, ports):
    return ports[request.param]


def _reps(out):
    return [segs_rep(s) for s in out]


@pytest.fixture
def recorder():
    rec = spans.Recorder()
    spans.install(rec)
    try:
        yield rec
    finally:
        spans.uninstall()


def _tree(rec, root):
    """The spans of each request under its root ``root``: {request:
    (root span, [its descendants])}; every span lies inside its parent,
    on its thread and of its request."""
    out = {}
    for s in rec.closed(root):
        assert s.parent is None
        out[s.req] = (s, [])
    for s in rec.closed():
        top = s
        while top.parent is not None:
            p = top.parent
            assert p.t0 <= top.t0 and top.t1 <= p.t1
            assert (p.thread, p.req) == (top.thread, top.req)
            top = p
        if top.name == root and top is not s:
            out[top.req][1].append(s)
    return out


def test_off_records_and_allocates_nothing(port):
    """Nothing installed: one shared no-op context, the function itself
    for a worker, no request on the handle, and a batch leaves no state
    on its thread; a span or count allocates no memory."""
    assert not spans.recording()
    assert spans.span("batch.begin") is spans.span("score") is spans.OFF
    assert spans.request() is spans.resume(3) is spans.OFF
    assert spans.task("fe.host", len) is len
    seen = {}

    def run():
        h = port.align_batch_begin([austen_audio(0)], [TEXT])
        seen["req"] = h.req
        seen["out"] = port.align_batch_end(h)
        seen["local"] = vars(spans._local).copy()

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    assert seen["req"] is None and seen["out"][0] and seen["local"] == {}

    def loop():
        for _ in range(1000):
            with spans.span("score"):
                spans.count("frames.scored", 64)
            with spans.request():
                pass

    loop()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        loop()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == spans.__file__ and d.size_diff]
    assert grown == []


def test_same_transcript_batch_tree(port, recorder):
    audios = [austen_audio(i) for i in range(5)]
    h1 = port.align_batch_begin(audios, [TEXT] * 5)
    h2 = port.align_batch_begin(audios[:3], [TEXT] * 3)
    out1, out2 = port.align_batch_end(h1), port.align_batch_end(h2)
    assert all(out1) and all(out2)
    assert h1.req != h2.req and None not in (h1.req, h2.req)
    begins, ends = _tree(recorder, "batch.begin"), _tree(recorder,
                                                         "batch.end")
    assert set(begins) == set(ends) == {h1.req, h2.req}
    fe = "fe.device" if port.native_fe is None else "fe.wait"
    for req in (h1.req, h2.req):
        names = {s.name for s in begins[req][1]}
        assert {"graphs", "pack", "consts", fe, "fe.device", "score",
                "viterbi", "download"} <= names <= BEGIN
        assert {s.name for s in ends[req][1]} == END
        # batch.end follows its batch.begin
        assert begins[req][0].t1 <= ends[req][0].t0


def test_mixed_batch_tree(port, recorder):
    audios = [austen_audio(i) for i in range(len(TEXTS))]
    h = port.align_batch_begin(audios, TEXTS)
    assert all(port.align_batch_end(h))
    (root, kids), = _tree(recorder, "batch.begin").values()
    names = {s.name for s in kids}
    assert {"graphs", "union", "stack", "pack", "fe.device", "score",
            "gather", "viterbi", "download"} <= names <= BEGIN
    assert {s.name for s in _tree(recorder, "batch.end")[root.req][1]} \
        == END


def test_longform_tree(port, recorder):
    text = " ".join([TEXT] * 2)
    audio = np.tile(austen_audio(1), 2)
    out = port.align_longform_batch([audio, audio[:-5000]], [text] * 2)
    assert all(out)
    (root, kids), = _tree(recorder, "longform").values()
    names = {s.name for s in kids}
    assert LONGFORM - {"fe.wait"} <= names <= LONGFORM
    assert ("fe.wait" in names) == (port.native_fe is not None)


def test_longform_fe_counters(port, recorder, monkeypatch):
    """longform.fe_early counts a call on the host FE and nothing on the
    device FE; longform.fe_ready at most that, and one a call where
    consts waits for the worker to drain."""
    audios = [austen_audio(i) for i in range(2)]
    for a in audios:
        assert port.align_longform_batch([a], [TEXT])[0]
    host = port.native_fe is not None
    assert recorder.counts.get("longform.fe_early", 0) == 2 * host
    assert recorder.counts.get("longform.fe_ready", 0) <= 2 * host
    if not host:
        return
    consts = port._graph_consts

    def drained(g):
        port._fe_pool.submit(lambda: None).result()
        return consts(g)

    monkeypatch.setattr(port, "_graph_consts", drained)
    before = recorder.counts.get("longform.fe_ready", 0)
    assert port.align_longform_batch(audios[:1], [TEXT])[0]
    assert recorder.counts["longform.fe_early"] == 3
    assert recorder.counts["longform.fe_ready"] == before + 1


def test_worker_spans_carry_their_request(ports, recorder):
    """fe.host runs on the host front end's worker thread, one span a
    call, under the request that submitted it, with no parent there."""
    port = ports["host"]
    audios = [austen_audio(i) for i in range(3)]
    h1 = port.align_batch_begin(audios, [TEXT] * 3)
    h2 = port.align_batch_begin(audios, TEXTS[:3])
    port.align_batch_end(h1)
    port.align_batch_end(h2)
    port.align_longform_batch(audios[:1], [TEXT])
    fe = recorder.closed("fe.host")
    roots = recorder.closed("longform")
    assert sorted(s.req for s in fe) == [h1.req, h2.req, roots[0].req]
    main = threading.main_thread().ident
    assert all(s.thread != main and s.parent is None for s in fe)
    assert len(recorder.per_request("fe.host")) == 3


def test_frame_counters(port, recorder):
    """frames.real: the real rows' frames; frames.scored: every scored
    row (pad rows too) times the frame axis."""
    audios = [austen_audio(i) for i in range(5)]
    Ts = [port.fe.n_frames(len(a)) for a in audios]
    port.align_batch_end(port.align_batch_begin(audios, [TEXT] * 5))
    port.align_batch_end(port.align_batch_begin(audios, TEXTS))
    Tmax = -(-max(Ts) // 64) * 64
    assert recorder.counts == {"frames.real": 2 * sum(Ts),
                               "frames.scored": 2 * 8 * Tmax}
    assert recorder.share_padded() == pytest.approx(
        100 * (1 - sum(Ts) / (8 * Tmax)))


def test_segments_equal_with_the_recorder_on(port):
    audios = [austen_audio(i) for i in range(3)]

    def run():
        same = port.align_batch_end(port.align_batch_begin(audios,
                                                           [TEXT] * 3))
        mixed = port.align_batch_end(port.align_batch_begin(audios,
                                                            TEXTS[:3]))
        long = port.align_longform_batch(audios[:1], [TEXT])
        return [_reps(same), _reps(mixed), _reps(long)]

    off = run()
    rec = spans.Recorder()
    spans.install(rec)
    try:
        on = run()
    finally:
        spans.uninstall()
    assert on == off and rec.spans


def test_labeller_takes_the_innermost_main_thread_span():
    """Nested main-thread spans and an overlapping worker-thread span:
    the innermost main-thread span open at t names it, else None."""
    rec = spans.Recorder()

    def put(name, t0, t1, thread, parent=None):
        s = spans.Span(rec, name)
        s.t0, s.t1, s.thread, s.parent, s.req = t0, t1, thread, parent, 1
        rec.spans.append(s)
        return s

    main = threading.main_thread().ident
    root = put("longform", 0.0, 10.0, main)
    put("graphs", 1.0, 3.0, main, root)
    put("fe.host", 2.0, 8.0, main + 1)
    score = put("score", 4.0, 6.0, main, root)
    put("inner", 4.5, 5.0, main, score)
    put("batch.end", 11.0, 12.0, main)
    label = rec.labeller()
    assert [label(t) for t in (-1.0, 0.5, 2.0, 3.5, 4.2, 4.7, 5.5, 9.0,
                               10.5, 11.5, 13.0)] == [
        None, "longform", "graphs", "longform", "score", "inner", "score",
        "longform", None, "batch.end", None]
    assert rec.labeller(main + 1)(5.0) == "fe.host"


def test_recorder_readers():
    rec = spans.Recorder()
    assert rec.median_ms("wait") is None and rec.share_padded() is None
    spans.install(rec)
    try:
        for _ in range(2):
            with spans.request():
                with spans.span("extract"):
                    pass
                with spans.span("segs"):
                    pass
        spans.count("frames.real", 3)
        spans.count("frames.scored", 4)
    finally:
        spans.uninstall()
    assert len(rec.per_request("extract", "segs")) == 2
    assert rec.median_ms("extract", "segs") >= 0.0
    assert rec.share_padded() == pytest.approx(25.0)


def test_counters_under_threads():
    """Counts from more threads than cores, with a short switch
    interval, lose no update."""
    import sys

    rec = spans.Recorder()
    spans.install(rec)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                spans.count("frames.real", 1)
                with spans.request(), spans.span("x"):
                    pass

        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        spans.uninstall()
    assert rec.counts["frames.real"] == 16 * 2000
    assert len({s.req for s in rec.spans}) == 16 * 2000
