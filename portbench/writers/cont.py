"""The ``cont`` model writer: a fully continuous acoustic model of one
39-dim stream and its dictionary, at the sizes a configuration file
gives, written from seeds.

The configuration's published numbers are the model's shape: CI phones
(CMU Sphinx en-us's 42), senones and CI senones, 3-state left-to-right
HMMs, a codebook per senone (no senmgau: ``n_codebook`` equals
``n_senone``) of ``n_density`` Gaussians over one stream of 39 dims
(``1s_c_d_dd`` without subvectors: cepstra, delta and delta-delta in
that order), top-N, the front end's filter bank and FFT size, and the
dictionary's entry count.  The mixture weights are a float
``mixture_weights`` file (no sendump), as continuous models ship them.

The mdef, the dictionary, the tying, the transition matrices and the
noise dictionary are the ``synth`` writer's (``writers/synth.py``, the
same seeds: its ``structure_seed`` draws the dictionary and the tying,
the run's seed the transition matrices); its PTM Gaussians and sendump
are replaced.  The run's seed then draws, as a stream of its own, the
means and variances around the per-dimension statistics of
``data/austen-feat.f32`` and the mixture weights.  Only numpy's MT19937
bits, IEEE arithmetic and ``math.fsum``/``sqrt`` are used, so the files
are the same bytes on any machine.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..reference.sst import s3file as s3
from . import synth

DIMS = 39


def write_mixw_float(path: str, pdf: np.ndarray) -> None:
    """Float mixture weights [n_sen, n_feat, n_comp] in the layout
    read_mixw and senone_mixw_read consume."""
    n_sen, n_feat, n_comp = pdf.shape
    with open(path, "wb") as fh:
        s3._write_s3_header(fh, "1.0")
        fh.write(np.array([n_sen, n_feat, n_comp, n_sen * n_feat * n_comp],
                          np.int32).tobytes())
        fh.write(np.asarray(pdf, np.float32).tobytes())


def write(outdir: str, conf: dict, seed: int) -> str:
    """Write mdef, means, variances, mixture_weights,
    transition_matrices, feat_params.json, dict.txt and noisedict.txt
    into outdir: the model of configuration ``conf``, its weights drawn
    from ``seed`` (taken modulo 2**32, MT19937's seed range)."""
    n_sen = conf["n_senone"]
    if (conf["n_codebook"] != n_sen or conf["n_stream"] != 1
            or conf["n_dim"] != [DIMS] or conf["feat"] != "1s_c_d_dd"):
        raise ValueError("the cont writer writes a codebook a senone over "
                         "one 1s_c_d_dd stream of 39 dims")
    synth.write(outdir, dict(conf, n_codebook=len(synth.EN_US_PHONES),
                             n_density=4), seed)
    for name in ("means", "variances", "sendump"):
        os.remove(os.path.join(outdir, name))
    rng = np.random.RandomState([seed % 2 ** 32, DIMS])
    mean, sd = (x.reshape(1, 1, 1, DIMS) for x in synth._feat_stats())
    shape = (n_sen, 1, conf["n_density"], DIMS)
    means = mean + 0.8 * sd * synth._normal(rng, shape)
    scale = sd * (0.35 + 0.5 * rng.random_sample(shape))
    s3.write_gauden_params(os.path.join(outdir, "means"),
                           means.astype(np.float32), [DIMS])
    s3.write_gauden_params(os.path.join(outdir, "variances"),
                           (scale * scale).astype(np.float32), [DIMS])
    # a few strong densities a senone
    u = rng.random_sample((n_sen, 1, conf["n_density"]))
    write_mixw_float(os.path.join(outdir, "mixture_weights"),
                     (u * u * u * u + 1e-3).astype(np.float32))
    path = os.path.join(outdir, "feat_params.json")
    with open(path) as fh:
        feat = json.load(fh)
    del feat["svspec"]
    with open(path, "w") as fh:
        json.dump(feat, fh, indent=1, sort_keys=True)
    return outdir
