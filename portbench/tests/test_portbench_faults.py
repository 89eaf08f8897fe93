"""A run with the timed path broken underneath reads ``correct`` false.

Each test skips the run's look for a card and drives the rest of a run
on the CPU (the port's plain versions), at a small size of the cells'
mixes on the small-width model, with one fault planted in the port:
a step that returns its state unchanged (the previous call's results),
half of the batch left out, an answer altered where it is produced.
The exchange between chips does not exist in these one-chip cells.
"""

import os

import pytest
import torch

from portbench.cells import Bench
from portbench.run import run_cell
from soundswallower_tpu_torch import aligner as port

from . import conftest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL = {"config": conftest.SMALL,
         "traffic": {"paragraphs": 3,
                     "sentences_per_paragraph": [1, 2],
                     "words_per_sentence": [3, 5], "readings": 2,
                     "check_batches": 2, "check_rows": 3,
                     "sentences_per_chapter": [1, 2], "chapter_sizes": 2,
                     "transcripts": 4}}
SEED = 2 ** 31 + 99


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SST_FE", "host")
    torch.set_num_threads(2)


def run(cell, control=None):
    return run_cell(Bench(ROOT), cell, SEED, 0.0, False, device="cpu",
                    overrides=SMALL, control=control)


def stale(monkeypatch, name):
    """The entry returns the previous call's results (the first call
    its own)."""
    real = getattr(port.TorchAligner, name)
    last = []

    def f(self, *a, **k):
        out = real(self, *a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    monkeypatch.setattr(port.TorchAligner, name, f)


def altered(segs):
    """One phone boundary moved by a frame, the segments still tiling
    the row and spelling the transcript."""
    s = next(s for s in segs if len(s.phones) > 1)
    (c0, st0, d0, sc0), (c1, st1, d1, sc1) = s.phones[:2]
    step = 1 if d1 > 1 else -1
    s.phones[0] = (c0, st0, d0 + step, sc0)
    s.phones[1] = (c1, st1 + step, d1 - step, sc1)
    return segs


@pytest.mark.parametrize("cell", ["ptm-story", "ptm-chapters"])
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", ["ptm-story", "ptm-chapters"])
def test_control_is_not_correct(cell):
    """The reference in bfloat16, put in the program's place, is judged
    by the same numbers and limits and fails them; the program's run
    beside it stays correct."""
    out = run(cell, control="bf16")
    assert out["correct"], out["checks"]
    assert not out["control"]["correct"], out["control"]
    assert out["control"]["checks"]["rows_differing"]["value"] > 0


@pytest.mark.parametrize("cell,entry", [
    ("ptm-story", "align_batch_end"),
    ("ptm-chapters", "align_longform_batch")])
def test_state_unchanged(monkeypatch, cell, entry):
    stale(monkeypatch, entry)
    assert not run(cell)["correct"]


def test_half_the_batch_left_out(monkeypatch):
    real = port.TorchAligner.align_batch_end

    def f(self, h):
        out = real(self, h)
        return out[:(len(out) + 1) // 2] + [None] * (len(out) // 2)
    monkeypatch.setattr(port.TorchAligner, "align_batch_end", f)
    out = run("ptm-story")
    assert not out["correct"] and out["checks"]["rows_failed"]["value"] > 0


def test_answer_altered_story(monkeypatch):
    real = port.TorchAligner._extract_batch_native

    def f(self, *a, **k):
        return [altered(s) for s in real(self, *a, **k)]
    monkeypatch.setattr(port.TorchAligner, "_extract_batch_native", f)
    out = run("ptm-story")
    assert not out["correct"]
    assert out["checks"]["rows_malformed"]["value"] == 0
    assert out["checks"]["rows_differing"]["value"] > 0


def test_answer_altered_chapters(monkeypatch):
    real = port.TorchAligner._extract_safe

    def f(self, *a, **k):
        return altered(real(self, *a, **k))
    monkeypatch.setattr(port.TorchAligner, "_extract_safe", f)
    out = run("ptm-chapters")
    assert not out["correct"]
    assert out["checks"]["rows_differing"]["value"] > 0
