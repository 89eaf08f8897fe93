"""The shared HTTP service in front of the PyTorch aligner (CPU)."""

import base64
import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir

from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.serve import make_server, segs_to_json

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    al = TorchAligner(hmm=model_dir(tmp_path_factory, "small"),
                      samprate=SAMPRATE, device="cpu")
    srv = make_server(al, "127.0.0.1", 0, max_wait_ms=50.0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield al, srv.server_address[1]
    srv.shutdown()
    srv.service.close()
    srv.server_close()
    th.join(timeout=10)


def _post(port: int, payload: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/align",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_concurrent_requests_match_align_batch(server):
    al, port = server
    audios = [austen_audio(i) for i in range(4)]
    frate = al.config.get_int("frate")
    want = [segs_to_json(s, frate)
            for s in al.align_batch(audios, [TEXT] * 4)]

    def post(i):
        return _post(port, {"text": TEXT, "audio": base64.b64encode(
            audios[i].tobytes()).decode()})

    with ThreadPoolExecutor(4) as ex:
        replies = list(ex.map(post, range(4)))
    assert [r[0] for r in replies] == [200] * 4
    assert [r[1] for r in replies] == want


def test_health_and_errors(server):
    al, port = server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/health",
                                timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["n_sen"] == al.am.n_sen
    a = base64.b64encode(austen_audio(0).tobytes()).decode()
    code, body = _post(port, {"text": "he was a xyzzy", "audio": a})
    assert code == 500 and "unknown word" in body["error"]
    code, _ = _post(port, {"text": TEXT})
    assert code == 400
