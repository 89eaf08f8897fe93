"""A cell, a traffic mix, a traffic kind and a per-layer metric added as
new files and entries only are picked up by name, with no file of the
harness edited."""

import json
import os
import shutil

from portbench.cells import Bench

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_fake_cell_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read()
              for p in map(str, (root / "portbench").rglob("*"))
              if os.path.isfile(p)}
    pb = root / "portbench"
    (pb / "kinds" / "sentences.py").write_text(
        "from .batches import *  # noqa: F401,F403\n"
        "from .batches import Story\n\n\n"
        "def make(params, seed, words):\n"
        "    return Story(dict(params, sentences_per_paragraph=[1, 1]),\n"
        "                 seed, words)\n")
    (pb / "traffic" / "sentences.json").write_text(json.dumps({
        "kind": "sentences", "text_seed": 0, "paragraphs": 8,
        "sentences_per_paragraph": [1, 1], "words_per_sentence": [3, 9],
        "zipf_s": 1.0, "in_flight": 2, "readings": 2, "dither_lsb": 2,
        "check_batches": 2, "check_rows": 4}))
    (pb / "workloads" / "ptm-sentences.json").write_text(
        json.dumps({"env": {"SST_FE": "host"}}))
    (pb / "metrics" / "rows_per_batch.py").write_text(
        "def read(ctx):\n    return 8.0\n")
    spec["workloads"].append({
        "name": "ptm-sentences", "config": "en-us-ptm",
        "traffic": "sentences", "chips": 1, "why": "a fake cell"})
    spec["per_layer"].append({
        "name": "rows_per_batch", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "batch pipeline",
        "moves": "audio_s_per_s", "workloads": ["ptm-sentences"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(str(root))
    cell = bench.cell("ptm-sentences")
    assert cell["traffic_params"]["paragraphs"] == 8
    assert cell["settings"]["env"] == {"SST_FE": "host"}
    assert [m["name"] for m in cell["per_layer"]] == [
        "device_idle_share", "mfu", "rows_per_batch"]
    # latency_p95_ms names its cells; the others report everywhere
    assert {m["name"] for m in cell["end_to_end"]} == {
        "audio_s_per_s", "setup_s"}
    assert bench.reader("rows_per_batch")(None) == 8.0
    kind = bench.module("kinds", cell["traffic_params"]["kind"])
    st = kind.make(cell["traffic_params"], 5, ["he", "was", "not"])
    assert len(st.texts) == 8 and len(st.reading(1)) == 8
    assert list(st.per_par) == [1] * 8
    assert callable(kind.loop) and callable(kind.check)
    # the old cells are as they were, and no file there changed
    assert bench.cell("ptm-story")["per_layer"] == Bench(ROOT).cell(
        "ptm-story")["per_layer"]
    for p, data in before.items():
        assert open(p, "rb").read() == data
