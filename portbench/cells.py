"""What the benchmark finds by name: ``BENCHMARK.json`` and each cell's
files.

* ``configs/<config>.json`` (the ``file`` of the configuration's entry):
  the model writer's settings (``writer``), the sample rate, the
  published sizes and what was assumed;
* ``writers/<kind>.py``: the model writer the configuration's
  ``writer.kind`` names, a ``write(outdir, config, seed)``;
* ``traffic/<traffic>.json``: a traffic mix's parameters, read by the
  module of ``kinds/`` that its ``kind`` names (``kinds/__init__.py``
  lists what a kind provides);
* ``workloads/<cell>.json``: the cell's settings of the program (its
  environment, such as the front end);
* ``metrics/<metric>.py``: a per-layer metric's reader, a ``read(ctx)``
  that returns the metric's value or None where it finds nothing to
  read (``ctx`` is ``metrics.Context``).

A later change adds a configuration, a model writer, a mix, a traffic
kind, a cell or a metric by adding its file and its entry, without
editing a file that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Bench:
    """``BENCHMARK.json`` (at ``root``) and the files of its cells, under
    its first path (``dir``)."""

    def __init__(self, root: str):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, self.spec["paths"][0])
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def cell(self, name: str) -> dict:
        """The cell's entry, with its configuration (``config_file``),
        traffic (``traffic_params``), settings (``settings``) and
        metrics (``end_to_end``, ``per_layer``: the entries that report
        in it) read."""
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = dict(self.cells[name])
        conf = self.configs[w["config"]]
        w["config_file"] = load_json(os.path.join(self.root, conf["file"]))
        w["traffic_params"] = load_json(
            os.path.join(self.dir, "traffic", w["traffic"] + ".json"))
        w["settings"] = load_json(os.path.join(self.dir, "workloads",
                                               name + ".json"))

        def here(m):
            return name in m.get("workloads", [name])

        w["end_to_end"] = [m for m in self.spec["end_to_end"] if here(m)]
        w["per_layer"] = [m for m in self.spec["per_layer"] if here(m)]
        return w

    def module(self, group: str, name: str):
        """The module ``<group>/<name>.py`` under this benchmark's path
        (``kinds``, ``writers``), loaded as a module of this package."""
        if not name.isidentifier():
            raise ValueError(f"{group} {name!r}: not a module name")
        path = os.path.join(self.dir, group, name + ".py")
        full = f"{__package__}.{group}.{name}"
        mod = sys.modules.get(full)
        if mod is not None and os.path.samefile(mod.__file__, path):
            return mod
        importlib.import_module(f"{__package__}.{group}")
        spec = importlib.util.spec_from_file_location(full, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        spec.loader.exec_module(mod)
        return mod

    def reader(self, name: str):
        """The ``read`` function of ``metrics/<name>.py``."""
        return reader(os.path.join(self.dir, "metrics", name + ".py"))


def reader(path: str):
    """The ``read`` function of the metric reader at ``path``."""
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
