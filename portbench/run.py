"""Run one cell of the port's benchmark once.

Usage, from the root of a checkout::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, model writer, traffic mix and kind, settings and metrics
are found by name (``cells``).  Set-up writes the model from the seed
(``writers/<kind>.py``), builds the port's ``TorchAligner`` on the card
(its kernels from the build directory inside the checkout, built there
on a checkout's first run), makes the traffic from the seed and warms up
every shape the traffic uses (``kinds/<kind>.py``).  The window then
runs the kind's closed loop for ``--seconds`` seconds, under a profiler
with ``--trace 1`` (``trace``).  After the window the peak memory is
read, the port's state is freed, and the plain reference decides
``correct`` (``check``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones and
``breakdown``), ``device``, ``built`` (whether set-up built the port's
libraries, as a checkout's first run does; its ``setup_s`` holds the
build), and last ``checks``, each number compared beside its limit; the
same numbers end standard error.

The run fails (exit 2, no result) without a CUDA device, with fewer
than the cell's chips, where the port cannot be imported, or where
``jax``, ``jaxlib``, ``flax`` or the JAX package ``soundswallower_tpu``
is loaded after set-up or at the end (top-level module names compared
whole).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

T_IMPORT = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "soundswallower_tpu")


class RunError(RuntimeError):
    """A run that must print no result."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _check_modules(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"{when}: modules loaded that the benchmark's runs "
                       f"must not load: {', '.join(found)}")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time and
    uptime, 10 ms resolution); since this module's import where /proc
    cannot tell."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def card(torch) -> dict:
    """The card's name and power limit."""
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"kind": name, "power_limit": limit or "unknown"}


def dictionary_words(model_dir: str) -> list[str]:
    """The dictionary's base words (alternate pronunciations left out),
    in file order."""
    with open(os.path.join(model_dir, "dict.txt")) as fh:
        words = [ln.split(None, 1)[0] for ln in fh if ln.strip()]
    return [w for w in words if "(" not in w]


def build_files() -> dict:
    """The port's built libraries (its kernels' and its native host
    code's) with their modification times."""
    import soundswallower_tpu_torch as pkg

    pkg_dir = os.path.dirname(os.path.abspath(pkg.__file__))
    out = {}
    for d in (os.path.join(pkg_dir, "_build"),
              os.path.join(os.path.dirname(pkg_dir), "native")):
        if os.path.isdir(d):
            for f in os.listdir(d):
                if f.endswith(".so"):
                    out[f] = os.path.getmtime(os.path.join(d, f))
    return out


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: str | None = None,
             overrides: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``overrides`` replaces configuration numbers or traffic parameters
    (``{"config": {...}, "traffic": {...}}``: the tests' small sizes);
    with ``control`` (a precision of the reference) the control is
    judged too, under the key ``control``."""
    import torch

    from . import check, gen, reduce
    from .reference.align import Reference
    from .trace import Spans, Tracer, device_view

    cell = bench.cell(name)
    over = overrides or {}
    conf = {**cell["config_file"], **over.get("config", {})}
    params = {**cell["traffic_params"], **over.get("traffic", {})}
    for k, v in cell["settings"].get("env", {}).items():
        os.environ[k] = str(v)
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell["chips"]):
        raise RunError(f"{name} needs {cell['chips']} CUDA device(s); "
                       f"{torch.cuda.device_count()} available")
    try:
        from soundswallower_tpu_torch.aligner import TorchAligner
    except ImportError as e:
        raise RunError(f"the port cannot be imported: {e}") from e
    samprate = int(conf["samprate"])
    kind = bench.module("kinds", params["kind"])
    built_before = build_files()
    marks = [("start", process_age_s())]
    tmp = tempfile.mkdtemp(prefix="portbench-model-")
    bench.module("writers", conf["writer"]["kind"]).write(tmp, conf, seed)
    marks.append(("model", process_age_s()))
    al = TorchAligner(hmm=tmp, samprate=samprate, device=device)
    marks.append(("aligner", process_age_s()))
    host_fe = os.environ.get("SST_FE", "host") != "device"
    if host_fe and al.native_fe is None:
        raise RunError("the cell runs the host front end, and the port's "
                       "native front end did not load")
    traffic = kind.make(params, seed, dictionary_words(tmp))
    marks.append(("traffic", process_age_s()))
    start = kind.warm(al, traffic)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", process_age_s()))
    built = build_files() != built_before
    _check_modules("after set-up")
    spans = Spans()
    rng = gen.rng_for(seed, 4)
    keep = kind.keeper(params, rng)
    gc.collect()
    gc.disable()
    try:
        setup_s = process_age_s()
        if trace:
            path = os.path.join(tmp, "trace.json")
            with Tracer(torch, path) as tr:
                rec = kind.loop(al, traffic, samprate, seconds, spans, keep,
                                start)
                torch.cuda.synchronize()
        else:
            rec = kind.loop(al, traffic, samprate, seconds, spans, keep,
                            start)
    finally:
        gc.enable()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
           if cuda else 0}
    view = device_view(tr, spans) if trace else None
    if view is not None:
        dev.update(busy_s=view["busy_s"], window_s=view["window_s"])
        for n, s in sorted(view["raw_names"].items(),
                           key=lambda kv: -kv[1])[:12]:
            print(f"device {s:.6f} s: {n[:160]}", file=sys.stderr)
    print(f"window: {rec.window_s:.3f} s, {len(rec.done)} calls, "
          f"{rec.attempted} rows, {rec.failed} failed, "
          f"{rec.audio_s / rec.window_s:.1f} audio-s/s; set-up "
          f"{setup_s:.2f} s{' (built the port)' if built else ''}: "
          + ", ".join(f"{n} {t1 - t0:.2f}" for (_, t0), (n, t1)
                      in zip(marks, marks[1:])), file=sys.stderr, flush=True)
    # free the port's state before the reference runs on the card
    del al
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = Reference(tmp, samprate, host_fe=host_fe, device=device)
    nums, ctl = kind.check(ref, traffic, keep.items, rec, params, rng,
                           control)
    t_ref = time.perf_counter() - t_ref
    work = kind.work(ref, traffic, rec, keep.items) if trace else None
    ctx = reduce.Context(rec, spans, setup_s, view, work)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = bench.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": check.verdict(nums), "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": dev,
           "built": built}
    if trace:
        top = sorted(view["by_name"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n, s] for n, s in top],
                            "idle_gaps": view["idle_gaps"]}
    if ctl is not None:
        out["control"] = {"correct": check.verdict(ctl),
                          "checks": check.limited(ctl)}
    out["checked"] = {k: v for k, v in nums.items() if k not in check.LIMITS}
    out["checked"].update(window_s=rec.window_s, reference_s=t_ref)
    out["checks"] = check.limited(nums)
    _check_modules("at the end")
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    os.rmdir(tmp)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from .cells import Bench

    try:
        import torch
        if torch.cuda.is_available():
            c = card(torch)
            print(f"card: {c['kind']}, power limit {c['power_limit']}",
                  file=sys.stderr)
        out = run_cell(Bench(os.getcwd()), a.workload, a.seed, a.seconds,
                       bool(a.trace))
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for k, v in out["checked"].items():
        print(f"{k}: {v}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
