"""Frozen copy of ``soundswallower_tpu_torch/config.py``
for the benchmark's reference (see ``__init__``).

Typed configuration system.

Mirrors the reference's parameter table (``include/soundswallower/
config_defs.h``: 74 typed parameters with defaults) and its behaviors:

* dict-like typed access (``config_int/float/str/bool`` in src/config.c)
* JSON parse/serialize round-trip (config.c:441,758)
* acoustic-model directory expansion + ``feat_params.json`` merge
  (``config_expand``, src/decoder.c:105-160)

Parameter names are identical to the reference so user configs and tests
carry over unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Any

# (name, type, default, help) — from config_defs.h.  Types: 'int', 'float',
# 'str', 'bool'.  REQARG_STRING 'hmm' is required-on-use, not at init.
_DEFN = [
    # DEBUG_OPTIONS
    ("logfn", "str", None, "File to write log messages in"),
    ("loglevel", "str", "WARN", "Minimum level of log messages"),
    # BEAM_OPTIONS (config_defs.h:77-90)
    ("beam", "float", 1e-48, "Beam width applied to every frame in Viterbi search"),
    ("wbeam", "float", 7e-29, "Beam width applied to word exits"),
    ("pbeam", "float", 1e-48, "Beam width applied to phone transitions"),
    # SEARCH_OPTIONS
    ("compallsen", "bool", False, "Compute all senone scores in every frame"),
    ("bestpath", "bool", True, "Run bestpath search over word lattice"),
    ("backtrace", "bool", False, "Print results and backtraces to log"),
    ("maxhmmpf", "int", 30000, "Maximum number of active HMMs per frame (-1 = off)"),
    # FSG_OPTIONS
    ("fsg", "str", None, "Sphinx format finite state grammar file"),
    ("jsgf", "str", None, "JSGF grammar file"),
    ("toprule", "str", None, "Start rule for JSGF"),
    ("fsgusealtpron", "bool", True, "Add alternate pronunciations to FSG"),
    ("fsgusefiller", "bool", True, "Insert filler words at each state"),
    # NGRAM_OPTIONS
    ("lw", "float", 6.5, "Language model probability weight"),
    ("ascale", "float", 20.0, "Inverse acoustic model scale for confidence"),
    ("wip", "float", 0.65, "Word insertion penalty"),
    ("pip", "float", 1.0, "Phone insertion penalty"),
    ("silprob", "float", 0.005, "Silence word transition probability"),
    ("fillprob", "float", 1e-8, "Filler word transition probability"),
    # DICT_OPTIONS
    ("dict", "str", None, "Main pronunciation dictionary input file"),
    ("fdict", "str", None, "Noise word pronunciation dictionary input file"),
    ("dictcase", "bool", False, "Dictionary is case sensitive"),
    # ACMOD_OPTIONS
    ("hmm", "str", None, "Directory containing acoustic model files"),
    ("featparams", "str", None, "File containing feature extraction parameters"),
    ("mdef", "str", None, "Model definition input file"),
    ("senmgau", "str", None, "Senone to codebook mapping input file"),
    ("tmat", "str", None, "HMM state transition matrix input file"),
    ("tmatfloor", "float", 0.0001, "HMM state transition probability floor"),
    ("mean", "str", None, "Mixture gaussian means input file"),
    ("var", "str", None, "Mixture gaussian variances input file"),
    ("varfloor", "float", 0.0001, "Mixture gaussian variance floor"),
    ("mixw", "str", None, "Senone mixture weights input file"),
    ("mixwfloor", "float", 0.0000001, "Senone mixture weights floor"),
    ("aw", "int", 1, "Inverse weight applied to acoustic scores"),
    ("sendump", "str", None, "Senone dump input file"),
    ("mllr", "str", None, "MLLR transformation to apply to means and variances"),
    ("mmap", "bool", True, "Use memory-mapped I/O for model files"),
    ("ds", "int", 1, "Frame GMM computation downsampling ratio"),
    ("topn", "int", 4, "Maximum number of top Gaussians to use in scoring"),
    ("topn_beam", "str", "0", "Beam width used to determine top-N Gaussians"),
    ("logbase", "float", 1.0001, "Base in which all log-likelihoods calculated"),
    ("cionly", "bool", False, "Use only context-independent phones"),
    # FE_OPTIONS (config_defs.h:267-418); non-WASM defaults
    ("logspec", "bool", False, "Write out logspectral files instead of cepstra"),
    ("smoothspec", "bool", False, "Write out cepstral-smoothed logspectral files"),
    ("transform", "str", "legacy", "Transform for cepstra (legacy, dct, htk)"),
    ("alpha", "float", 0.97, "Preemphasis parameter"),
    ("samprate", "int", 16000, "Sampling rate"),
    ("frate", "int", 100, "Frame rate"),
    ("wlen", "float", 0.025625, "Hamming window length"),
    ("nfft", "int", 0, "Size of FFT, or 0 to set automatically"),
    ("nfilt", "int", 40, "Number of filter banks"),
    ("lowerf", "float", 133.33334, "Lower edge of filters"),
    ("upperf", "float", 6855.4976, "Upper edge of filters"),
    ("unit_area", "bool", True, "Normalize mel filters to unit area"),
    ("round_filters", "bool", True, "Round mel filter frequencies to DFT points"),
    ("ncep", "int", 13, "Number of cep coefficients"),
    ("doublebw", "bool", False, "Use double bandwidth filters"),
    ("lifter", "int", 0, "Length of sin-curve for liftering, 0 for none"),
    ("input_endian", "str", "little", "Endianness of input data"),
    ("warp_type", "str", "inverse_linear", "Warping function type"),
    ("warp_params", "str", None, "Parameters defining the warping function"),
    ("dither", "bool", False, "Add 1/2-bit noise"),
    ("seed", "int", -1, "Seed for random number generator"),
    ("remove_dc", "bool", False, "Remove DC offset from each frame"),
    ("remove_noise", "bool", False, "Remove noise using spectral subtraction"),
    ("verbose", "bool", False, "Show input filenames"),
    # FEAT_OPTIONS
    ("feat", "str", "1s_c_d_dd", "Feature stream type"),
    ("ceplen", "int", 13, "Number of components in the input feature vector"),
    ("cmn", "str", "live", "Cepstral mean normalization scheme"),
    ("cmninit", "str", "40,3,-1", "Initial values for live cepstral mean"),
    ("varnorm", "bool", False, "Variance normalize each utterance"),
    ("lda", "str", None, "Feature transformation matrix file"),
    ("ldadim", "int", 0, "Dimensionality of feature transformation output"),
    ("svspec", "str", None, "Subvector specification"),
]

TYPES = {name: typ for name, typ, _, _ in _DEFN}
DEFAULTS = {name: dflt for name, _, dflt, _ in _DEFN}


def _coerce(name: str, value: Any) -> Any:
    typ = TYPES[name]
    if value is None:
        return None
    if typ == "int":
        if isinstance(value, str):
            return int(float(value))
        return int(value)
    if typ == "float":
        return float(value)
    if typ == "bool":
        if isinstance(value, str):
            return value.lower() in ("yes", "true", "t", "y", "1")
        return bool(value)
    if typ == "str":
        if isinstance(value, bool):
            return "yes" if value else "no"
        return str(value)
    raise KeyError(name)


class Config(dict):
    """Typed configuration with reference-compatible parameter names.

    Dict-like access plus JSON round trip; unknown keys raise KeyError just
    like the reference errors on unknown parameters.
    """

    def __init__(self, *args, **kwargs):
        super().__init__()
        for name, _, dflt, _ in _DEFN:
            super().__setitem__(name, dflt)
        init = dict(*args, **kwargs) if (args or kwargs) else {}
        for k, v in init.items():
            self[k] = v

    # dash-prefixed keys accepted for CLI compatibility
    @staticmethod
    def _norm(key: str) -> str:
        key = key.lstrip("-")
        if key not in TYPES:
            raise KeyError(f"Unknown configuration parameter: {key}")
        return key

    def __getitem__(self, key):
        return super().__getitem__(self._norm(key))

    def __setitem__(self, key, value):
        key = self._norm(key)
        super().__setitem__(key, _coerce(key, value))

    def __delitem__(self, key):
        """Unset a parameter (pyx Config.__delitem__): string/path
        parameters go to None, typed parameters back to their default."""
        key = self._norm(key)
        super().__setitem__(key, None if TYPES[key] == "str" else DEFAULTS[key])

    def dumps(self) -> str:
        """Serialize to JSON (pyx Config.dumps)."""
        return self.serialize_json()

    def get_int(self, key) -> int:
        v = self[key]
        return 0 if v is None else int(v)

    def get_float(self, key) -> float:
        v = self[key]
        return 0.0 if v is None else float(v)

    def get_bool(self, key) -> bool:
        v = self[key]
        return bool(v)

    def get_str(self, key):
        return self[key]

    def describe(self):
        """Iterate over (name, type, default, help) like Config.describe()."""
        for name, typ, dflt, hlp in _DEFN:
            yield name, typ, dflt, hlp

    # -- JSON (config.c:441 parse, :758 serialize) -------------------------

    def parse_json(self, json_text: str) -> None:
        """Update from a JSON object or ``"key": value`` fragment string."""
        text = json_text.strip()
        if not text.startswith("{"):
            text = "{" + text + "}"
        obj = json.loads(text)
        for k, v in obj.items():
            self[k] = v

    def serialize_json(self) -> str:
        out = {}
        for name, typ, _, _ in _DEFN:
            v = super().__getitem__(name)
            if v is None:
                continue
            out[name] = v
        return json.dumps(out, indent=2)

    # -- model expansion (src/decoder.c:105-160 config_expand) -------------

    def expand(self) -> None:
        hmmdir = self["hmm"]
        if hmmdir:
            for key, fname in (
                ("mdef", "mdef"),
                ("mean", "means"),
                ("var", "variances"),
                ("tmat", "transition_matrices"),
                ("mixw", "mixture_weights"),
                ("sendump", "sendump"),
                ("lda", "feature_transform"),
                ("featparams", "feat_params.json"),
                ("senmgau", "senmgau"),
                ("dict", "dict.txt"),
                ("fdict", "noisedict.txt"),
            ):
                if self[key] is None:
                    path = os.path.join(hmmdir, fname)
                    if os.path.exists(path):
                        self[key] = path
        featparams = self["featparams"]
        if featparams and os.path.exists(featparams):
            with open(featparams) as fh:
                self.parse_json(fh.read())
