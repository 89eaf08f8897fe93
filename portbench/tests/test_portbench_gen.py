"""The traffic kinds and the model writer: the same seed gives the same
traffic and model, every seed the same sizes, and the sizes are those
the mixes and the configuration state."""

import json
import os

import numpy as np
import pytest

from portbench import gen
from portbench.kinds import batches, longform
from portbench.run import dictionary_words
from portbench.writers import synth

from .conftest import small_config

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = 2 ** 31 + 12345


def mix(name, **kw):
    with open(os.path.join(HERE, "traffic", name + ".json")) as fh:
        p = json.load(fh)
    p.update(kw)
    return p


@pytest.fixture(scope="module")
def words(small_model):
    return dictionary_words(small_model)


@pytest.fixture(scope="module")
def stories(words):
    p = mix("story", readings=2)
    return [batches.make(p, s, words) for s in (BIG, BIG, 7)]


def test_story_same_seed_same_traffic(stories):
    a, b, _ = stories
    assert a.texts == b.texts
    for i in range(2):
        assert all(np.array_equal(x, y)
                   for x, y in zip(a.reading(i), b.reading(i)))


def test_story_sizes_as_stated(stories, words):
    p = mix("story")
    for st in stories:
        assert len(st.texts) == p["paragraphs"] == len(st.reading(0))
        lo, hi = p["sentences_per_paragraph"]
        want = lo + np.arange(128) % (hi - lo + 1)
        assert sorted(st.per_par) == sorted(want)
        for t, n in zip(st.texts, st.per_par):
            assert set(t.split()) <= set(words)
        # each sentence is one utterance of 298 frames at most
        for a, n in zip(st.reading(0), st.per_par):
            base = len(gen.base_audio())
            assert n * (base - gen.CUT_STEP * (gen.CUT_KINDS - 1)) \
                <= len(a) <= n * base


def test_story_every_seed_the_same_work(stories):
    a, _, c = stories
    assert a.texts != c.texts and sorted(a.texts) == sorted(c.texts)
    for i in range(2):
        assert sum(map(len, a.reading(i))) == sum(map(len, c.reading(i)))


def test_readings_differ(stories):
    a = stories[0]
    assert not all(np.array_equal(x, y)
                   for x, y in zip(a.reading(0), a.reading(1)))


def test_zipf_counts():
    k = gen.zipf_counts(1000, 50, 1.0)
    assert k.sum() == 1000 and np.all(np.diff(k) <= 0)
    w = 1.0 / np.arange(1, 51)
    assert np.all(np.abs(k - 1000 * w / w.sum()) < 1)


def test_story_words_by_rank(stories, words):
    used = " ".join(stories[0].texts).split()
    n = {w: used.count(w) for w in set(used)}
    assert n[words[0]] == max(n.values())
    want = gen.zipf_counts(len(used), len(words), 1.0)
    assert sorted(n.values(), reverse=True) == sorted(
        want[want > 0].tolist(), reverse=True)


def test_chapters(words):
    p = mix("chapters", transcripts=22)
    a, b = (longform.make(p, BIG, words) for _ in range(2))
    lo, hi = p["sentences_per_chapter"]
    assert a.sizes[0] == lo and a.sizes[-1] == hi
    assert len(a.sizes) == p["chapter_sizes"]
    texts = set()
    for i in range(2 * len(a.sizes)):
        (xa, ta), (xb, tb) = a.chapter(i), b.chapter(i)
        assert ta == tb and np.array_equal(xa, xb)
        wl, wh = p["words_per_sentence"]
        assert wl * a.size(i) <= len(ta.split()) <= wh * a.size(i)
        texts.add(ta)
    assert len(texts) == 2 * len(a.sizes)          # a new transcript a call
    for block in (0, 1):
        k = len(a.sizes)
        assert sorted(a.size(block * k + j) for j in range(k)) == a.sizes
    # every chapter of one size holds the same words
    assert sorted(a.chapter(0)[1].split()) == sorted(
        a.chapter(len(a.sizes))[1].split())
    warm = [t for _, t in a.warm]
    assert not set(warm) & texts


def test_writer_same_seed_same_files(tmp_path, small_model):
    synth.write(str(tmp_path / "a"), small_config(), 3)
    for f in os.listdir(small_model):
        assert open(os.path.join(small_model, f), "rb").read() == open(
            tmp_path / "a" / f, "rb").read(), f


def test_writer_sizes_as_stated(tmp_path):
    conf = small_config()
    synth.write(str(tmp_path / "m"), conf, 5)
    lines = open(tmp_path / "m" / "dict.txt").read().splitlines()
    assert len(lines) == conf["dictionary_words"]
    prons = [ln.split()[1:] for ln in lines]
    speech = [p for p in synth.EN_US_PHONES if p not in synth.FILLERS]
    assert {p for pr in prons for p in pr} == set(speech)
    assert all(2 <= len(pr) <= 12 for pr in prons)
    mdef = open(tmp_path / "m" / "mdef").read().splitlines()
    assert mdef[4] == f"{conf['n_senone']} n_tied_state"
    sen = {int(x) for ln in mdef[10:] for x in ln.split()[6:9]}
    assert sen == set(range(conf["n_senone"]))
    feat = json.load(open(tmp_path / "m" / "feat_params.json"))
    assert feat["nfft"] == conf["nfft"] == 512
    head = open(tmp_path / "m" / "sendump", "rb").read(400)
    assert b"cluster_bits 4" in head


def test_structure_fixed_weights_from_the_seed(tmp_path):
    conf = small_config()
    synth.write(str(tmp_path / "a"), conf, 1)
    synth.write(str(tmp_path / "b"), conf, 2)
    same = {f: open(tmp_path / "a" / f, "rb").read() == open(
        tmp_path / "b" / f, "rb").read() for f in os.listdir(tmp_path / "a")}
    assert same["mdef"] and same["dict.txt"]
    assert not same["means"] and not same["sendump"]
