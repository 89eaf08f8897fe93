"""A small model of the benchmark's configuration: the same writer,
phones and tying at a size the CPU tests afford."""

import json
import os

import pytest

from portbench.writers import synth

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL = {"n_senone": 126 + 39 * 9, "n_density": 32, "dictionary_words": 400}


def small_config(**kw) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "en-us-ptm.json")) as fh:
        conf = json.load(fh)
    conf.update(SMALL)
    conf.update(kw)
    return conf


@pytest.fixture(scope="session")
def small_model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("small-model"))
    synth.write(d, small_config(), 3)
    return d
