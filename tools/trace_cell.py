"""One run of a cell of the port's benchmark (``portbench``) with the
port's span recorder (``soundswallower_tpu_torch.spans``) installed over
the window, and what the recorder read.

    python3 tools/trace_cell.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The run is ``portbench.run.run_cell``'s, unchanged (set-up, the window,
the plain reference's check), with a ``spans.Recorder`` installed just
before the traffic kind's loop and removed when it returns; with
``--trace 1`` the device trace's idle gaps are also labelled by the
program's spans.  The last line of standard output is run_cell's result
object with ``program`` added:

* ``end_to_end``: ``audio_s_per_s`` and ``latency_p95_ms`` of the
  window (read by the benchmark's readers from its record; a traced
  run_cell reports its per-layer metrics only);
* ``metrics``: ``wait_ms.p50`` (the ``wait`` span), ``extract_ms.p50``
  (``extract`` + ``segs``), ``graph_ms.p50`` (``graphs`` + ``consts``:
  the graph and its device tables), ``host_fe_ms.p50`` (``fe.host``),
  each a median over calls of the call's spans summed, and
  ``padded_frame_share`` (100 x (1 - frames.real / frames.scored));
* ``roots``: per program root (``batch.begin``, ``batch.end``,
  ``longform``) its calls, median ms, the share of its time its direct
  children cover (lowest and median over calls), each child's median
  ms a call and the counters named after it (``longform.fe_early``,
  ``longform.fe_ready``: the calls whose host FE was submitted before
  ``graphs``, and had finished when ``consts`` ended);
* ``bench_minus_root_ms``: per benchmark span (``begin``, ``end``,
  ``chapter``) the median over calls of its time less that of the
  program root it holds;
* ``launches``: each kernel wrapper's launches in the window, and
  ``layouts``: by layout, those of the Viterbi wrappers that count one
  (``viterbi_rows``, ``viterbi_chunk``: "block", "cluster N", "global
  memory"), and ``forms``: by form, those of the wrappers that count
  one (``ms_dist_topn``: "frame top-N", "registers 13", "runtime L";
  ``dist_topn_norm``: "fold", "mxu"; ...);
* ``ms``, where the continuous scorer ran: the recorder's
  ``ms_dist_topn.forms`` (K11's launches by form), ``ms.blocks`` (its
  frame blocks) and ``ms.blocks_per_score`` (over the ``score`` spans),
  and ``ms.block_frames`` (the largest block);
* with ``--trace 1``, ``idle_gaps``: the ten longest idle gaps, the
  benchmark's label then ``/`` and the innermost main-thread program
  span open at the gap's middle (the benchmark's label alone where none
  is); ``idle_s_by_label`` over every gap; ``idle_named_share``, the
  share of idle seconds in gaps that name a program span; and
  ``gaps_as_benchmark``, whether the ten gaps' durations and order are
  the benchmark's own ``breakdown``'s.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from portbench import reduce, trace  # noqa: E402
from portbench.cells import Bench  # noqa: E402
from portbench.run import RunError, card, run_cell  # noqa: E402
from soundswallower_tpu_torch import spans  # noqa: E402

ROOTS = {"begin": "batch.begin", "end": "batch.end",
         "chapter": "longform"}


def wrappers() -> dict:
    """The port's kernel wrappers that count their launches."""
    from soundswallower_tpu_torch.fe import feat, frontend
    from soundswallower_tpu_torch.ops import align_torch, senscore_torch

    out = {}
    for mod in (feat, frontend, align_torch, senscore_torch):
        for name, fn in vars(mod).items():
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int):
                out[name] = fn
    return out


class _Recorded:
    """A traffic kind whose loop runs under ``rec``; keeps the loop's
    record, the benchmark's spans and the launches it made, by wrapper
    and, where a wrapper counts them, by layout."""

    def __init__(self, kind, rec: spans.Recorder):
        self._kind, self.rec = kind, rec
        self.record = self.bench_spans = self.launches = None
        self.layouts = self.forms = None

    def __getattr__(self, name):
        return getattr(self._kind, name)

    def loop(self, al, traffic, samprate, seconds, bench_spans, keep,
             start=0):
        fns = wrappers()
        before = {n: f.launches for n, f in fns.items()}
        lay0 = {n: dict(f.layouts) for n, f in fns.items()
                if hasattr(f, "layouts")}
        form0 = {n: dict(f.forms) for n, f in fns.items()
                 if hasattr(f, "forms")}
        spans.install(self.rec)
        try:
            self.record = self._kind.loop(al, traffic, samprate, seconds,
                                          bench_spans, keep, start)
        finally:
            spans.uninstall()
        self.bench_spans = bench_spans
        self.launches = {n: f.launches - before[n] for n, f in fns.items()
                         if f.launches != before[n]}
        self.layouts = _diff(fns, lay0, "layouts")
        self.forms = _diff(fns, form0, "forms")
        return self.record


def _diff(fns: dict, before: dict, counter: str) -> dict:
    """Per wrapper, its ``counter``'s counts added since ``before``."""
    out = {}
    for n, b in before.items():
        d = {k: v - b.get(k, 0) for k, v in getattr(fns[n], counter).items()
             if v != b.get(k, 0)}
        if d:
            out[n] = d
    return out


class _Bench(Bench):
    """The benchmark, its traffic kinds run under ``rec``."""

    def __init__(self, root: str, rec: spans.Recorder):
        super().__init__(root)
        self.rec, self.kind = rec, None

    def module(self, group: str, name: str):
        mod = super().module(group, name)
        if group != "kinds":
            return mod
        self.kind = _Recorded(mod, self.rec)
        return self.kind


def label_gaps(ops, tr, bench_spans, program_label) -> list:
    """Every idle gap of the window as (seconds, the benchmark's label,
    the program's innermost main-thread span or None), longest first:
    the gaps and the benchmark's labels as ``trace.device_view`` finds
    them (``ops`` its device operations, the marker first)."""
    offset = ops[0][1] - tr.marker_host
    lo, hi = tr.t0 + offset, tr.t1 + offset
    gaps, end = [], lo
    for _, a, b in ops[1:]:
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    items = sorted(bench_spans.items, key=lambda s: s[1])
    starts = [t0 for _, t0, _ in items]

    def bench_label(t: float) -> str:     # host time
        i = bisect.bisect_right(starts, t) - 1
        return items[i][0] if i >= 0 and t < items[i][2] else "client"

    out = []
    for a, b in gaps:
        if b > a:
            t = (a + b) / 2 - offset
            out.append((b - a, bench_label(t), program_label(t)))
    out.sort(key=lambda g: g[:2], reverse=True)
    return out


def idle_view(gaps: list, view: dict) -> dict:
    def name(g):
        return g[1] if g[2] is None else f"{g[1]}/{g[2]}"

    by: dict[str, float] = {}
    for g in gaps:
        by[name(g)] = by.get(name(g), 0.0) + g[0]
    total = sum(g[0] for g in gaps)
    named = sum(g[0] for g in gaps if g[2] is not None)
    return {"idle_gaps": [[name(g), g[0]] for g in gaps[:10]],
            "idle_s_by_label": dict(sorted(by.items(),
                                           key=lambda kv: -kv[1])),
            "idle_named_share": named / total if total else None,
            "gaps_as_benchmark": [[g[1], g[0]] for g in gaps[:10]]
            == view["idle_gaps"]}


@contextlib.contextmanager
def labelled_view(rec: spans.Recorder, out: dict):
    """``trace.device_view`` as it is, and into ``out`` the gaps labelled
    by the program's spans (read from the same trace file)."""
    orig = trace.device_view

    def view(tr, bench_spans):
        ops = trace.device_ops(tr.path)
        v = orig(tr, bench_spans)
        if ops:
            out.update(idle_view(label_gaps(ops, tr, bench_spans,
                                            rec.labeller()), v))
        return v

    trace.device_view = view
    try:
        yield
    finally:
        trace.device_view = orig


def roots(rec: spans.Recorder) -> dict:
    kids: dict = {}
    for s in rec.closed():
        if s.parent is not None and s.parent.parent is None:
            kids.setdefault(id(s.parent), []).append(s)
    out = {}
    for root in sorted(set(ROOTS.values())):
        calls = rec.closed(root)
        if not calls:
            continue
        cover = [sum(k.seconds for k in kids.get(id(r), [])) / r.seconds
                 for r in calls]
        names = sorted({k.name for r in calls for k in kids.get(id(r), [])})
        per = {}
        for n in names:
            per[n] = statistics.median(
                sum(k.seconds for k in kids.get(id(r), []) if k.name == n)
                for r in calls) * 1e3
        out[root] = {"calls": len(calls),
                     "ms_p50": statistics.median(r.seconds
                                                 for r in calls) * 1e3,
                     "children_cover_min": min(cover),
                     "children_cover_p50": statistics.median(cover),
                     "children_ms_p50": per,
                     "counts": {k: v for k, v in rec.counts.items()
                                if k.startswith(root + ".")}}
    return out


def bench_minus_root(rec: spans.Recorder, bench_spans) -> dict:
    """Per benchmark span, the median over calls of its seconds less
    those of the program root inside it, in ms."""
    out = {}
    for name, root in ROOTS.items():
        rs = sorted(rec.closed(root), key=lambda s: s.t0)
        t0s = [r.t0 for r in rs]
        diff = []
        for n, a, b in bench_spans.items:
            if n != name:
                continue
            i = bisect.bisect_left(t0s, a)
            if i < len(rs) and rs[i].t1 <= b:
                diff.append((b - a) - rs[i].seconds)
        if diff:
            out[name] = {"calls": len(diff),
                         "ms_p50": statistics.median(diff) * 1e3}
    return out


def ms_counts(rec: spans.Recorder) -> dict:
    """The continuous scorer's counters: K11's forms, the frame blocks
    (in all and per ``score`` span) and the largest block; empty where
    it did not run."""
    pre = "ms_dist_topn.forms["
    forms = {k[len(pre):-1]: v for k, v in rec.counts.items()
             if k.startswith(pre)}
    if "ms.blocks" not in rec.counts:
        return {}
    scores = len(rec.closed("score"))
    return {"ms_dist_topn.forms": forms,
            "ms.blocks": rec.counts["ms.blocks"],
            "ms.blocks_per_score": (rec.counts["ms.blocks"] / scores
                                    if scores else None),
            "ms.block_frames": rec.counts.get("ms.block_frames")}


def program(rec: spans.Recorder, kind: _Recorded, bench: Bench) -> dict:
    ctx = reduce.Context(kind.record, kind.bench_spans, 0.0)
    e2e = {m: bench.reader(m)(ctx) for m in ("audio_s_per_s",
                                             "latency_p95_ms")}
    metrics = {"wait_ms.p50": rec.median_ms("wait"),
               "extract_ms.p50": rec.median_ms("extract", "segs"),
               "graph_ms.p50": rec.median_ms("graphs", "consts"),
               "host_fe_ms.p50": rec.median_ms("fe.host"),
               "padded_frame_share": rec.share_padded()}
    return {"end_to_end": e2e,
            "metrics": {k: v for k, v in metrics.items() if v is not None},
            "counts": rec.counts, "roots": roots(rec),
            "bench_minus_root_ms": bench_minus_root(rec, kind.bench_spans),
            "launches": kind.launches, "layouts": kind.layouts,
            "forms": kind.forms, "ms": ms_counts(rec)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/trace_cell.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch

    if torch.cuda.is_available():
        c = card(torch)
        print(f"card: {c['kind']}, power limit {c['power_limit']}",
              file=sys.stderr)
    rec = spans.Recorder()
    bench = _Bench(os.getcwd(), rec)
    idle: dict = {}
    try:
        with labelled_view(rec, idle):
            out = run_cell(bench, a.workload, a.seed, a.seconds,
                           bool(a.trace))
    except RunError as e:
        print(f"trace_cell: {e}", file=sys.stderr)
        return 2
    out["program"] = {**program(rec, bench.kind, bench), **idle}
    print(json.dumps(out["program"], indent=1), file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
