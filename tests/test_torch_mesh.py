"""The data-parallel mesh (parallel/mesh.py, parallel/multihost.py,
TorchAligner.use_mesh, dryrun.py) on the CPU against the single-device
port and against TpuAligner under the JAX package's data_mesh on as many
virtual devices: same and mixed transcripts, the scored route, grammar
decode and its scored form, bit for bit; a batch whose rows do not
divide over the ranks; two processes on gloo, each with its own rows;
the dry run on the synthetic model."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir, segs_rep
from make_torch_decode_golden import GRAMMAR, decode_rep
from make_torch_mixed_golden import scored_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.parallel.mesh import data_mesh as jax_data_mesh
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.dryrun import dryrun_multichip
from soundswallower_tpu_torch.parallel import (DataMesh, data_mesh,
                                               replicate, shard_batch)
from soundswallower_tpu_torch.parallel.multihost import (
    GlobalBatch, global_data_mesh, host_batch_to_global, initialize,
    local_results)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = [TEXT, "young man", "he was not", "an ill man",
         "disposed young man he was"]
ROWS = 5


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


@pytest.fixture(scope="module")
def aligners(small_dir):
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    for al in (port, ref):
        al.set_grammar(jsgf_string=GRAMMAR)
    return port, ref


def scenario(al) -> dict:
    """ROWS utterances through every batch entry point, in one order
    (the union scorer depends on the batches before it)."""
    audios = [austen_audio(i) for i in range(ROWS)]
    return dict(
        same=[segs_rep(s) for s in al.align_batch(audios, [TEXT] * ROWS)],
        mixed=[segs_rep(s) for s in al.align_batch(audios, TEXTS)],
        scored=[scored_rep(s) for s in al.align_batch_scored(audios, TEXTS)],
        decode=[decode_rep(r) for r in al.decode_batch(audios)],
        decode_scored=[decode_rep(r)
                       for r in al.decode_batch_scored(audios)])


@pytest.fixture(scope="module")
def single(aligners):
    port, _ = aligners
    port.use_mesh(None)
    out = scenario(port)
    assert all(r is not None for rows in out.values() for r in rows)
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_mesh_equals_single_device_and_jax(aligners, single, n):
    """use_mesh(data_mesh(n)) on n virtual CPU ranks (3: 5 rows padded
    to 9) gives the single-device port's results and TpuAligner's under
    the JAX data_mesh(n), on every batch entry point; each rank gets
    its share of the padded batch."""
    port, ref = aligners
    port.use_mesh(data_mesh(n, "cpu"))
    ref.use_mesh(jax_data_mesh(n))
    try:
        assert port._nd_local() == ref._nd_local() == n
        got = scenario(port)
        want = scenario(ref)
        audios = [austen_audio(i) for i in range(ROWS)]
        for texts in ([TEXT] * ROWS, TEXTS):
            h = port.align_batch_begin(audios, texts)
            B = -(-8 // n) * n
            assert [p.paths.shape[0] for p in h.parts] == [B // n] * n
            assert [segs_rep(s) for s in port.align_batch_end(h)] == \
                (single["same"] if texts[1] == TEXT else single["mixed"])
    finally:
        port.use_mesh(None)
        ref.use_mesh(None)
    assert got == single
    assert got == want


def test_use_mesh_none_returns_to_one_device(aligners, single):
    """use_mesh(None) after a mesh: one part, the aligner's device, the
    single-device results; the caches were cleared on each change."""
    port, _ = aligners
    port.use_mesh(data_mesh(2, "cpu"))
    port.align_batch([austen_audio(0)] * 2, TEXTS[:2])
    assert port._uni is not None and port._stack_cache
    port.use_mesh(None)
    assert port.mesh is None and port._uni is None
    assert not port._stack_cache and not port._graph_const_cache
    assert scenario(port) == single
    h = port.align_batch_begin([austen_audio(0)], [TEXT])
    assert len(h.parts) == 1
    port.align_batch_end(h)


def test_data_mesh_devices():
    """Virtual ranks on one device; a CUDA device that is absent raises,
    with no CPU in its place."""
    m = data_mesh(3, "cpu")
    assert m.devices == (torch.device("cpu"),) * 3 and m.size == 3
    assert m.distinct() == [torch.device("cpu")]
    assert data_mesh(device="cpu").size == 1
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(RuntimeError, match="absent"):
            data_mesh(1, f"cuda:{n}")
        with pytest.raises(RuntimeError, match="ranks on"):
            data_mesh(n + 1, "cuda")
    else:
        for dev in ("cuda", "cuda:0", "cuda:1"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                data_mesh(1, dev)


def test_shard_batch_and_replicate():
    """shard_batch splits dim 0 into the ranks' rows (a tree per rank,
    B divisible by the ranks); replicate gives every rank the tree on
    its device, one copy a device."""
    m = data_mesh(4, "cpu")
    x = np.arange(24, dtype=np.int32).reshape(8, 3)
    t = torch.arange(8.0)
    parts = shard_batch(m, {"x": x, "t": [t]})
    assert len(parts) == 4
    for r, p in enumerate(parts):
        assert isinstance(p["x"], torch.Tensor)
        assert np.array_equal(p["x"].numpy(), x[2 * r:2 * r + 2])
        assert torch.equal(p["t"][0], t[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="rows over"):
        shard_batch(data_mesh(3, "cpu"), x)
    reps = replicate(m, {"t": t, "k": 3})
    assert all(r["t"] is t and r["k"] == 3 for r in reps)


def test_multihost_single_process():
    """Without a coordinator initialize does nothing; the global mesh is
    the local one, process 0 of 1; host_batch_to_global and
    local_results round-trip the rows, a row-local step between."""
    initialize(None)
    m = global_data_mesh(4, "cpu")
    assert isinstance(m, DataMesh)
    assert (m.process_index, m.process_count, m.size) == (0, 1, 4)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    g = host_batch_to_global(m, x)
    assert isinstance(g, GlobalBatch)
    assert (g.offset, g.total) == (0, 8) and len(g.shards) == 4
    assert np.array_equal(local_results(g.map(lambda a: a * 2)), x * 2)
    assert np.array_equal(local_results(g), x)


WORKER = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, addr, path, model = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, sys.argv[5])
from make_torch_synth_golden import SAMPRATE, austen_audio, segs_rep
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.parallel.multihost import (
    global_data_mesh, host_batch_to_global, initialize, local_results)
import torch.distributed as dist
initialize(addr, 2, rank)
mesh = global_data_mesh(2, "cpu")
assert (mesh.process_index, mesh.process_count) == (rank, 2)
local = np.arange(12, dtype=np.float32).reshape(4, 3) + 12 * rank
g = host_batch_to_global(mesh, local)
back = local_results(g.map(lambda a: a * 2))
texts = json.loads(sys.argv[6])[2 * rank:2 * rank + 2]
audios = [austen_audio(2 * rank + i) for i in range(2)]
al = TorchAligner(hmm=model, samprate=SAMPRATE, device="cpu")
one = [segs_rep(s) for s in al.align_batch(audios, texts)]
al.use_mesh(mesh)
got = [segs_rep(s) for s in al.align_batch(audios, texts)]
json.dump(dict(offset=g.offset, total=g.total,
               back_ok=bool((back == local * 2).all()), one=one, got=got),
          open(f"{path}/out{rank}.json", "w"))
dist.destroy_process_group()
"""


def test_two_process_gloo_mesh(aligners, tmp_path, small_dir):
    """Two processes on gloo, each with a mesh of 2 virtual ranks:
    host_batch_to_global learns each one's offset (0 and 4 of 8 rows of
    a toy batch) and local_results returns its rows; each process's
    align_batch on its own 2 utterances
    under the mesh equals its one-process result and this process's
    result for those rows.  The processes run under their own 180 s
    limit, so a hang fails here."""
    port, _ = aligners
    texts = [TEXT, "young man", "he was not", TEXT]
    (tmp_path / "worker.py").write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(r), addr,
         str(tmp_path), small_dir, os.path.join(REPO, "tools"),
         json.dumps(texts)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    port.use_mesh(None)
    for r in range(2):
        out = json.loads((tmp_path / f"out{r}.json").read_text())
        assert (out["offset"], out["total"]) == (4 * r, 8)
        assert out["back_ok"]
        want = [segs_rep(s) for s in port.align_batch(
            [austen_audio(2 * r + i) for i in range(2)],
            texts[2 * r:2 * r + 2])]
        assert out["got"] == out["one"] == want


def test_dryrun_on_synthetic_model(small_dir, capsys):
    """dryrun.py's data-parallel and sequence-parallel paths agree on
    tests/golden/austen.raw and the synthetic model, on 2 and 3 virtual
    ranks, through its function and its command line; a row that fails
    fails the run."""
    raw = os.path.join(REPO, "tests", "golden", "austen.raw")
    segs = dryrun_multichip(2, small_dir, raw, TEXT, device="cpu",
                            samprate=SAMPRATE)
    assert [w for w, _, _ in segs if w != "<sil>"] == TEXT.split()
    from soundswallower_tpu_torch import dryrun
    assert dryrun.main(["3", small_dir, raw, TEXT, "--device", "cpu",
                        "--samprate", str(SAMPRATE)]) == 0
    out = capsys.readouterr().out
    assert "dryrun_multichip(3): DP OK" in out
    assert "dryrun_multichip(3): SP OK (matches DP)" in out
    # 400 samples cannot reach the transcript's final state
    short = np.fromfile(raw, np.int16)[:400]
    with pytest.raises(AssertionError, match="DP alignment failed"):
        dryrun_multichip(2, small_dir, short, TEXT, device="cpu",
                         samprate=SAMPRATE)
