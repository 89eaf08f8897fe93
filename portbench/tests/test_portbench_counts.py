"""The count functions against hand counts, and the reduction of a
trace and spans to the per-layer metrics."""

import json

import pytest

from portbench import counts, reduce, trace
from portbench.counts import Row


def test_fold_hand_count():
    w = counts.fold(frames=2, codebooks=3, streams=1, density=4, dims=5,
                    topn=2)
    # per frame, codebook, density and dim: x - mu, a square, an FMA
    assert w.ops == 4 * 2 * 3 * 4 * 5
    # features 2 x 5 f32; top-N scores and indices 2 x 3 x 2 int32 each;
    # means and variances 3 x 4 x 5 f32 each and 3 x 4 constants
    assert w.nbytes == 4 * 10 + 8 * 12 + 4 * (3 * 4 * 11)
    assert w.rate == counts.F32_OPS
    assert w.least_s == max(w.nbytes / counts.HBM_BPS, w.ops / w.rate)


def test_senone_eval_hand_count():
    w = counts.senone_eval(3 * 5 + 2 * 4, streams=3, topn=4)
    # per (frame, senone, stream): the first term's add, 5 per later
    # term, and the add of the stream sum
    assert w.ops == (3 * 5 + 2 * 4) * 3 * (1 + 5 * 3 + 1)
    assert w.rate == counts.I32_OPS


def test_viterbi_hand_counts():
    r = Row(frames=10, states=6, phones=2, preds=1, senones=6)
    w = counts.viterbi_rows([r, r])
    assert w.ops == 2 * 10 * 10 * 6
    tables = 4 * 2 * (3 * 4 + 3) + 8 * 1
    assert w.nbytes == 2 * (4 * 60 + 2 * 10 + tables)
    c = counts.viterbi_chunk(r)
    assert c.ops == 10 * 60 and c.nbytes == 6 * 60 + tables
    big = Row(frames=1, states=40000, phones=1, preds=0, senones=1)
    assert counts.viterbi_chunk(big).nbytes == 8 * 40000 + 4 * (3 * 4 + 3)


def write_trace(path, events):
    with open(path, "w") as fh:
        json.dump({"traceEvents": [
            {"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d}
            for c, n, ts, d in events] + [
            {"ph": "X", "cat": "cpu_op", "name": "aten::x", "ts": 0,
             "dur": 1e9}]}, fh)


def test_device_view(tmp_path):
    # trace clock = host clock + 100 s; the marker first, at host 1.0 s
    path = str(tmp_path / "t.json")
    write_trace(path, [
        ("kernel", "void at::fill<float>(float)", 101.0e6, 1.0),
        ("kernel", "void dist_topn_norm_kernel<4, false>(float const*)",
         101.2e6, 0.3e6),
        ("gpu_memcpy", "Memcpy HtoD", 101.4e6, 0.2e6),
        ("kernel", "viterbi_rows_kernel(RowArgs)", 101.45e6, 0.1e6),
        ("kernel", "void dist_topn_norm_kernel<4, false>(float const*)",
         102.5e6, 0.1e6)])
    tr = trace.Tracer(None, path)
    tr.marker_host, tr.t0, tr.t1 = 1.0, 1.0, 3.0
    spans = trace.Spans()
    spans.items = [("end", 1.65, 2.0), ("begin", 2.1, 2.4)]
    v = trace.device_view(tr, spans)
    assert v["window_s"] == 2.0
    assert v["busy_s"] == pytest.approx(0.4 + 0.1)    # 1.2-1.6, 2.5-2.6
    assert v["by_name"]["dist_topn_norm_kernel"] == pytest.approx(0.4)
    assert v["by_name"]["viterbi_rows_kernel"] == pytest.approx(0.1)
    gaps = v["idle_gaps"]
    # 1.6-2.5 (middle 2.05, between the spans), 2.6-3.0 (none), 1.0-1.2
    assert [g[0] for g in gaps] == ["client", "client", "client"]
    assert [g[1] for g in gaps] == pytest.approx([0.9, 0.4, 0.2])
    spans.items = [("end", 2.0, 2.5)]     # the gap 1.6-3.0, middle 2.3
    write_trace(path, [("kernel", "m", 101.0e6, 1.0),
                       ("kernel", "k", 101.2e6, 0.4e6)])
    assert trace.device_view(tr, spans)["idle_gaps"][0][0] == "end"


def test_short_name():
    assert trace.short_name(
        "void ms_senone_eval_kernel<4, (Mode)1>(int const*, int)") == \
        "ms_senone_eval_kernel"
    assert trace.short_name("viterbi_rows_kernel(RowArgs)") == \
        "viterbi_rows_kernel"
    assert trace.short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD"
    assert trace.short_name(
        "void (anonymous namespace)::dist_topn_norm_kernel<4, (bool)0>"
        "(float const*, int)") == "dist_topn_norm_kernel"
    assert trace.short_name("void at::native::vectorized_elementwise_kernel"
                            "<4, at::native::FillFunctor<float>>(int)") == \
        "at::native::vectorized_elementwise_kernel"


def test_roofline_reads_nothing_without_a_trace():
    ctx = reduce.Context(None, trace.Spans(), 1.0)
    assert ctx.roofline("k2", "dist_topn_norm_kernel") is None
    w = counts.Work(67e9, 0.0, counts.F32_OPS)            # 1 ms at peak
    ctx = reduce.Context(None, trace.Spans(), 1.0,
                         {"by_name": {"dist_topn_norm_kernel": 0.004},
                          "window_s": 1.0, "busy_s": 0.5},
                         {"k2": w})
    assert ctx.roofline("k2", "dist_topn_norm_kernel") == pytest.approx(25.0)
    assert ctx.roofline("k6", "viterbi_rows_kernel") is None
