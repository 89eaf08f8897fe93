"""HTTP serving for the PyTorch aligner.

``AlignService`` (the dynamic batcher), ``make_server`` and
``segs_to_json`` are the JAX package's own (``soundswallower_tpu/
serve.py``, loaded through ``_shared``): they take any aligner with the
batch API.  Only ``main`` differs: it builds a :class:`TorchAligner`.

Run: ``python -m soundswallower_tpu_torch.serve --model <dir> --port 8000``.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from ._shared import load

_serve = load("serve")
AlignService = _serve.AlignService
make_server = _serve.make_server
segs_to_json = _serve.segs_to_json
LOG = logging.getLogger("soundswallower_tpu_torch.serve")


def main(argv=None):
    from .aligner import TorchAligner

    ap = argparse.ArgumentParser(
        description="Batched forced-alignment server (PyTorch/CUDA)")
    ap.add_argument("--model", required=True,
                    help="acoustic model directory (hmm)")
    ap.add_argument("--dict", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--prewarm-text", default=None,
                    help="representative transcript: pin the serving size "
                         "classes at startup (silence audio + this text)")
    args = ap.parse_args(argv)
    kw = dict(hmm=args.model)
    if args.dict:
        kw["dict"] = args.dict
    aligner = TorchAligner(device="cuda", **kw)
    server = make_server(aligner, args.host, args.port,
                         args.max_batch, args.max_wait_ms)
    if args.prewarm_text:
        rate = aligner.config.get_int("samprate")
        server.service.prewarm([(np.zeros(rate, np.int16), args.prewarm_text)])
    LOG.info("serving on %s:%d", args.host, args.port)
    try:
        server.serve_forever()
    finally:
        server.service.close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
