"""The ``ms-story`` cell on the continuous configuration: its files found
by name, its writer's bytes fixed by the seed, its reference
(``reference.cont.ContReference``) equal to the port at a small size on
the CPU and its control and planted faults read as not correct, a hand
count of K12's work, and the cell added beside the benchmark's files
without changing one."""

import copy
import hashlib
import json
import os
import subprocess

import pytest

from portbench import gen
from portbench.cells import Bench
from portbench.check import verdict
from portbench.counts import HBM_BPS, I32_OPS, ms
from portbench.loops import Record
from portbench.reference.align import Reference, seg_rep
from portbench.reference.cont import ContReference
from portbench.run import dictionary_words
from portbench.writers import cont, synth

from .conftest import small_config
from .test_portbench_faults import altered

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# a small model of the continuous configuration: its writer, phones,
# tying and one 39-dim stream, few senones and Gaussians
SMALL = {"n_senone": 126 + 39 * 6, "n_codebook": 126 + 39 * 6,
         "n_density": 4, "dictionary_words": 300}
MIX = {"kind": "batches_cont", "text_seed": 0, "paragraphs": 3,
       "sentences_per_paragraph": [1, 1], "words_per_sentence": [3, 6],
       "zipf_s": 1.0, "in_flight": 2, "readings": 1, "dither_lsb": 2,
       "check_batches": 1, "check_rows": 3}


def cont_config(**kw) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "en-us-cont.json")) as fh:
        conf = json.load(fh)
    conf.update(SMALL)
    conf.update(kw)
    return conf


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


@pytest.fixture(scope="module")
def cont_model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cont-model"))
    cont.write(d, cont_config(), 2 ** 31 + 17)
    return d


def _digest(d: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(d)):
        h.update(name.encode())
        with open(os.path.join(d, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def test_cell_files_found_by_name(bench):
    w = bench.cell("ms-story")
    conf = w["config_file"]
    assert conf["name"] == "en-us-cont" == w["config"] and w["chips"] == 1
    assert (conf["n_codebook"], conf["n_senone"], conf["n_stream"],
            conf["n_density"], conf["n_dim"]) == (5126, 5126, 1, 32, [39])
    assert conf["assumed"] and conf["left_out"]
    assert bench.configs["en-us-cont"]["reduced"] == []
    story = json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                        "story.json")))
    assert w["traffic_params"] == dict(story, kind="batches_cont")
    assert w["settings"] == {"env": {"SST_FE": "device"}}
    kind = bench.module("kinds", "batches_cont")
    assert all(callable(getattr(kind, f)) for f in (
        "make", "warm", "keeper", "loop", "check", "work"))
    assert bench.module("writers", conf["writer"]["kind"]).write \
        is not None
    assert {m["name"] for m in w["end_to_end"]} == {"audio_s_per_s",
                                                    "setup_s"}
    assert [m["name"] for m in w["per_layer"]] == [
        "device_idle_share", "mfu", "k11_roofline", "k12_roofline"]
    for m in w["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_writer_bytes_fixed_by_the_seed(tmp_path):
    """The same seed writes the same bytes, another seed other weights;
    the mdef, dictionary and transition matrices are the synth writer's
    at the same structure seed and run seed; one stream of 39 dims, a
    codebook a senone, float weights, no sendump and no svspec."""
    a, b, c = (str(tmp_path / n) for n in "abc")
    cont.write(a, cont_config(), 7)
    cont.write(b, cont_config(), 7)
    cont.write(c, cont_config(), 8)
    assert _digest(a) == _digest(b) != _digest(c)
    s = str(tmp_path / "s")
    synth.write(s, small_config(n_senone=SMALL["n_senone"],
                                dictionary_words=300, n_density=4), 7)
    for name in ("mdef", "dict.txt", "noisedict.txt",
                 "transition_matrices"):
        assert open(os.path.join(a, name), "rb").read() == open(
            os.path.join(s, name), "rb").read(), name
    assert sorted(os.listdir(a)) == sorted(
        ["dict.txt", "feat_params.json", "mdef", "means",
         "mixture_weights", "noisedict.txt", "transition_matrices",
         "variances"])
    ref = Reference(a, 8000, host_fe=False)
    assert ref.am.backend == "ms" and ref.am.n_mgau == ref.am.n_sen
    assert tuple(ref.am.means.shape) == (SMALL["n_senone"], 1, 4, 39)
    assert ref.config["svspec"] is None


def gen_story(model):
    from portbench.kinds import batches_cont
    return batches_cont.make(MIX, 11, dictionary_words(model))


@pytest.fixture(scope="module")
def port_run(cont_model):
    """One batch of the small story through the port on the CPU (device
    front end, as the cell), kept as the loop keeps it."""
    os.environ["SST_FE"] = "device"
    try:
        from soundswallower_tpu_torch.aligner import TorchAligner
        al = TorchAligner(hmm=cont_model, samprate=8000, device="cpu")
        assert al.native_fe is None and al.streams == (1, 39)
        st = gen_story(cont_model)
        out = al.align_batch_end(al.align_batch_begin(st.reading(0),
                                                      st.texts))
    finally:
        del os.environ["SST_FE"]
    rec = Record()
    rec.t0, rec.t1 = 0.0, 1.0
    rec.done.append(dict(rows=len(out), failed=0, latency_s=1.0,
                         audio_s=1.0, index=0))
    return st, out, rec


def _check(cont_model, st, kept, rec, control=None):
    from portbench.kinds import batches_cont
    ref = Reference(cont_model, 8000, host_fe=False)
    return batches_cont.check(ref, st, kept, rec, MIX, gen.rng_for(5, 4),
                              control)


def test_reference_equals_the_port(cont_model, port_run):
    """ContReference, built over the harness's Reference, gives the
    port's segments row for row; the check reads correct, and its
    bfloat16 control does not."""
    st, out, rec = port_run
    ref = ContReference.of(Reference(cont_model, 8000, host_fe=False))
    want = ref.align_rows(st.reading(0), st.texts)
    assert [seg_rep(s) for s in out] == [seg_rep(s) for s in want]
    nums, ctl = _check(cont_model, st, [(0, out)], rec, "bf16")
    assert verdict(nums) and nums["rows_checked"] == 3
    assert not verdict(ctl) and ctl["rows_differing"] > 0


def test_planted_faults_are_not_correct(cont_model, port_run):
    """A row dropped (None) and an answer altered (a phone boundary moved
    by a frame) each read correct false."""
    st, out, rec = port_run
    dropped = list(out)
    dropped[1] = None
    nums, _ = _check(cont_model, st, [(0, dropped)], rec)
    assert not verdict(nums) and nums["rows_malformed"] > 0
    moved = [copy.deepcopy(s) for s in out]
    moved[0] = altered(moved[0])
    nums, _ = _check(cont_model, st, [(0, moved)], rec)
    assert not verdict(nums)
    assert nums["rows_malformed"] == 0 and nums["rows_differing"] > 0


def test_k12_hand_count():
    """K12 over 10 frames of 3 senones on 3 codebooks, one stream, top-2,
    4 densities: 8 x 10 x 3 x 1 x 2 = 480 int32 operations; bytes 8 x
    10 x 3 x 2 (distances and densities in) + 3 x 4 (weights) + 2 x 10
    x 3 (scores out) = 552; bound by its bytes."""
    w = ms.senone_eval(10, 3, 3, 1, 2, 4)
    assert (w.ops, w.nbytes, w.rate) == (480.0, 552.0, I32_OPS)
    assert w.least_s == 552.0 / HBM_BPS
    # the story batch: 300,434 frames of 5,126 senones: 49.3 GB in, 3.1
    # GB out
    big = ms.senone_eval(300434, 5126, 5126, 1, 4, 32)
    assert 52e9 < big.nbytes < 53e9 and big.least_s > big.peak_s


def test_work_counts_every_codebook(cont_model, port_run):
    """The kind's work: K11 over every codebook and senone of the model
    (4 operations a density and dim), K12, K6; from the real frames."""
    from portbench.kinds import batches_cont
    from portbench.reduce import graph_row
    st, out, rec = port_run
    ref = Reference(cont_model, 8000, host_fe=False)
    work = batches_cont.work(ref, st, rec, [(0, out)])
    assert set(work) == {"k11", "k12", "k6"}
    frames = sum(graph_row(ref, t, ref.fe.n_frames(len(a))).frames
                 for t, a in zip(st.texts, st.reading(0)))
    C = SMALL["n_codebook"]
    assert work["k11"].ops == 4.0 * frames * C * 1 * 4 * 39
    assert work["k12"].ops == 8.0 * frames * C * 1 * 4


def test_only_files_added_beside_the_benchmark():
    """The commit that brought the continuous configuration (or, before
    it is committed, the working tree) changes no file the benchmark
    had under portbench/: it only adds."""
    def git(*a):
        return subprocess.run(["git", *a], cwd=ROOT, capture_output=True,
                              text=True)
    if git("rev-parse", "--git-dir").returncode != 0:
        pytest.skip("not a git checkout")
    path = "portbench/configs/en-us-cont.json"
    added = git("log", "--diff-filter=A", "--format=%H", "--",
                path).stdout.split()
    if added:
        r = git("diff", "--name-status", f"{added[-1]}^", added[-1], "--",
                "portbench")
        lines = r.stdout.splitlines()
    else:
        r = git("status", "--porcelain", "--untracked-files=all", "--",
                "portbench")
        lines = [ln for ln in r.stdout.splitlines()
                 if "__pycache__" not in ln]
    assert r.returncode == 0 and lines
    changed = [ln for ln in lines if ln.split()[0] not in ("A", "??")]
    assert not changed, changed


def test_warm_refuses_a_program_that_misreads_the_stream():
    """A program that does not say it reads one stream of 39 dims (the
    parent of this configuration read K1's output as 3 x 13 whatever
    the model) stops the run before anything is launched."""
    from portbench.kinds import batches_cont
    from portbench.run import RunError

    class Old:
        streams = (3, 13)

    for al in (Old(), object()):
        with pytest.raises(RunError, match="one stream of 39"):
            batches_cont.warm(al, None)
