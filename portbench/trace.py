"""Spans on the host clock, and the device's view from a profiler trace.

The traced run records CUDA activity only (``torch.profiler`` with
``ProfilerActivity.CUDA``: kernels, copies and sets on the device), not
the CPU operators, whose tracing stretches the window.  The benchmark's
own spans are kept on the host clock (``Spans``).  To place them on the
trace's timeline, ``Tracer`` launches one marker kernel on an idle
device just after the window opens: the first device operation of the
trace is that marker, and the offset between its start and the host
time of its launch maps host times onto the trace (to within the launch
latency, some microseconds).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import time

KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named host-clock spans [t0, t1) in seconds (perf_counter)."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> list[float]:
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymous
    part, template arguments and parameters: ``void (anonymous
    namespace)::dist_topn_norm_kernel<4, false>(float const*, ...)`` ->
    ``dist_topn_norm_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


class Tracer:
    """A torch.profiler session over the window, CUDA activity only."""

    def __init__(self, torch, path: str):
        self.torch = torch
        self.path = path
        self.prof = None
        self.marker_host = None
        self.t0 = self.t1 = None

    def __enter__(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        buf = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        buf.fill_(1.0)
        self.marker_host = time.perf_counter()
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        """Stop at the window's end (after its last synchronize)."""
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.path)
        return False


def device_ops(path: str) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of every device operation in a chrome
    trace, sorted by start, on the trace's clock."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    ops = [(ev.get("name", ""), float(ev["ts"]) * 1e-6,
            (float(ev["ts"]) + float(ev.get("dur", 0.0))) * 1e-6)
           for ev in events
           if ev.get("ph") == "X" and ev.get("cat") in KINDS]
    ops.sort(key=lambda x: x[1])
    return ops


def union_s(ops, lo: float, hi: float) -> float:
    """Seconds of [lo, hi) in which some operation of ``ops`` ran."""
    total, cur0, cur1 = 0.0, None, None
    for _, a, b in ops:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def device_view(tr: Tracer, spans: Spans) -> dict:
    """The window on the device: ``window_s``, ``busy_s`` (the union of
    its operations), device time by short and by full name, and the
    longest idle gaps labelled by the span the host was in at the gap's
    middle ("client" where it was in none)."""
    ops = device_ops(tr.path)
    os.remove(tr.path)
    if not ops:
        return {"window_s": tr.t1 - tr.t0, "busy_s": 0.0, "by_name": {},
                "raw_names": {}, "idle_gaps": []}
    offset = ops[0][1] - tr.marker_host       # trace clock - host clock
    lo, hi = tr.t0 + offset, tr.t1 + offset
    raw: dict[str, float] = {}
    for n, a, b in ops[1:]:
        raw[n] = raw.get(n, 0.0) + (b - a)
    by_name: dict[str, float] = {}
    for n, s in raw.items():
        by_name[short_name(n)] = by_name.get(short_name(n), 0.0) + s
    ops = [(short_name(n), a, b) for n, a, b in ops[1:]]
    # idle gaps between the union's intervals, inside the window
    gaps, end = [], lo
    for _, a, b in ops:
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    starts = [t0 + offset for _, t0, _ in spans.items]
    order = sorted(range(len(starts)), key=starts.__getitem__)
    starts = [starts[i] for i in order]
    items = [spans.items[i] for i in order]

    def label(t: float) -> str:       # the spans do not overlap
        i = bisect.bisect_right(starts, t) - 1
        return items[i][0] if i >= 0 and t < items[i][2] + offset \
            else "client"

    gaps = sorted(((b - a, label((a + b) / 2)) for a, b in gaps if b > a),
                  reverse=True)
    return {"window_s": tr.t1 - tr.t0, "busy_s": union_s(ops, lo, hi),
            "by_name": by_name, "raw_names": raw,
            "idle_gaps": [[n, d] for d, n in gaps[:10]]}
