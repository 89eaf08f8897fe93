"""``tools/trace_cell.py``: a benchmark cell run with the port's span
recorder over its window.  Its gap labels on a fabricated device trace
(nested main-thread spans and an overlapping worker-thread span: the
innermost main-thread span names the gap, the benchmark's gaps and
labels unchanged), and the chapters cell at a small size on the CPU, in
a process of its own (a benchmark run refuses one that has loaded
JAX)."""

import json
import os
import subprocess
import sys
import threading

from soundswallower_tpu_torch import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import trace_cell  # noqa: E402
from portbench import trace  # noqa: E402


class _Tr:
    """A finished Tracer: its window, marker and trace file."""

    def __init__(self, path, marker_host, t0, t1):
        self.path, self.marker_host, self.t0, self.t1 = \
            path, marker_host, t0, t1


def _put(rec, name, t0, t1, thread, parent=None):
    s = spans.Span(rec, name)
    s.t0, s.t1, s.thread, s.parent, s.req = t0, t1, thread, parent, 1
    rec.spans.append(s)
    return s


def test_gaps_named_by_the_innermost_main_thread_span(tmp_path):
    host0, dev0 = 10.0, 0.5                # the marker on both clocks
    offset = dev0 - host0
    kernels = [(10.010, 10.020), (10.030, 10.050), (10.060, 10.090)]
    events = [{"ph": "X", "cat": "kernel", "name": n,
               "ts": (a + offset) * 1e6, "dur": (b - a) * 1e6}
              for n, (a, b) in [("marker", (host0, host0 + 1e-6))]
              + [(f"void k{i}<1>(int)", k) for i, k in enumerate(kernels)]]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = _Tr(str(path), host0, 9.9995, 10.1)
    bench = trace.Spans()
    bench.items.append(("chapter", 10.000, 10.093))
    rec = spans.Recorder()
    main = threading.main_thread().ident
    root = _put(rec, "longform", 10.001, 10.094, main)
    graphs = _put(rec, "graphs", 10.002, 10.027, main, root)
    _put(rec, "inner", 10.021, 10.029, main, graphs)
    _put(rec, "fe.host", 10.040, 10.070, main + 1)
    _put(rec, "fe.wait", 10.051, 10.059, main, root)
    out: dict = {}
    orig = trace.device_view
    with trace_cell.labelled_view(rec, out):
        view = trace.device_view(tr, bench)
    assert trace.device_view is orig and not path.exists()
    want = ["chapter/graphs", "chapter/inner", "chapter/fe.wait", "client"]
    got = sorted(out["idle_gaps"], key=lambda g: want.index(g[0]))
    assert [g[0] for g in got] == want
    assert [round(g[1], 9) for g in got] == [0.0105, 0.01, 0.01, 0.01]
    assert [n for n, _ in view["idle_gaps"]] == [
        g[0].split("/")[0] for g in out["idle_gaps"]]
    assert out["gaps_as_benchmark"]
    assert round(out["idle_named_share"], 9) == round(0.0305 / 0.0405, 9)


def test_chapters_cell_reads_the_program(tmp_path):
    """The chapters cell at a small size on the CPU: its program root's
    children cover it, and the recorder's metrics are there."""
    code = f"""
import json, os, sys
sys.path[:0] = [{REPO!r}, {os.path.join(REPO, "tools")!r}]
import torch
torch.set_num_threads(2)
import trace_cell
from portbench.run import run_cell
from portbench.tests.test_portbench_faults import SMALL, SEED
from soundswallower_tpu_torch import spans
rec = spans.Recorder()
bench = trace_cell._Bench({REPO!r}, rec)
out = run_cell(bench, "ptm-chapters", SEED, 0.0, False, device="cpu",
               overrides=SMALL)
print(json.dumps([out["correct"], trace_cell.program(rec, bench.kind,
                                                     bench)]))
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(HOME=str(tmp_path), TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    correct, prog = json.loads(r.stdout.strip().splitlines()[-1])
    assert correct
    assert set(prog["metrics"]) == {"wait_ms.p50", "extract_ms.p50",
                                    "graph_ms.p50", "host_fe_ms.p50",
                                    "padded_frame_share"}
    root = prog["roots"]["longform"]
    assert root["children_cover_min"] >= 0.95
    assert {"graphs", "consts", "fe.wait", "score", "viterbi", "backtrace",
            "wait", "extract"} <= set(root["children_ms_p50"])
    counts = root["counts"]
    assert counts["longform.fe_early"] == root["calls"]
    assert 0 <= counts.get("longform.fe_ready", 0) <= root["calls"]
    assert prog["bench_minus_root_ms"]["chapter"]["calls"] >= 1
    assert prog["counts"]["frames.scored"] >= prog["counts"]["frames.real"]
