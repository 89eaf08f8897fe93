"""Decoder: the public facade (reference: src/decoder.c + acmod.c glue).

Wires together config -> front end -> features -> senone scoring -> FSG
beam search, and the two-pass forced alignment protocol
(decoder_alignment, decoder.c:737-798: pass-1 word segs constrain the
pass-2 state-align search windows).  Also hosts the senone-active
bookkeeping (acmod_activate_hmm / acmod_flags2list with 255-delta
bridging, acmod.c:905-999) and the line-JSON result writer
(decoder_result_json, decoder.c:1502-1593).

This is the exactness path, a copy of the JAX package's Decoder: the
search, the senone scoring (``ops/senscore.py``) and the features
(``fe/feat.py``'s numpy half) run on the host; the front end runs on the
card, through the port's ``Frontend`` (kernels K8-K10): ``Frontend.mfcc``
for a full utterance, ``Frontend.mfcc_chunk`` with the pre-emphasis
prior and noise carry for live chunks, bucketed as the JAX Decoder
buckets them (samples to a multiple of 2,048, frames to 128).
``Decoder(..., device="cuda")`` is the default; ``device="cpu"`` runs
the front end's plain PyTorch version.  The batch pipeline lives in
``aligner.py``.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .align import Alignment
from .am import AcousticModel
from .config import Config
from .dict2pid import Dict2Pid
from .dictionary import Dictionary
from .fe.feat import FeatPipeline
from .fe.frontend import Frontend
from .fsg import FsgModel
from .jsgf import Jsgf
from .logmath import LogMath
from .ops.senscore import MsScorerNp, ScorerNp
from .search_align import StateAlignSearch
from .search_fsg import FsgSearch
from .utils import resolve_device, to_device

LOG = logging.getLogger("soundswallower_tpu_torch")


def senone_flags2list(active: set[int]) -> np.ndarray:
    """acmod_flags2list (acmod.c:947-999): evaluated senone ids, including
    the 255-delta "bridge" senones inserted for large gaps."""
    out = []
    l = 0
    for sen in sorted(active):
        delta = sen - l
        while delta > 255:
            l += 255
            out.append(l)
            delta -= 255
        out.append(sen)
        l = sen
    return np.asarray(out, dtype=np.int64)


_LOGLEVELS = ("DEBUG", "INFO", "WARN", "WARNING", "ERROR", "FATAL")


class Decoder:
    def __init__(self, config: Config | dict | None = None,
                 device: str | torch.device = "cuda", **kwargs):
        self.device = resolve_device(device)
        if config is None:
            config = Config(**kwargs)
        elif not isinstance(config, Config):
            config = Config(config)
        self._config = config
        # Model expansion happens once at creation (decoder_init_config ->
        # config_expand, decoder.c:244-286); `initialize` / reinit does NOT
        # re-expand, so users can `del decoder.config["dict"]` first.
        config.expand()
        self.initialize()

    @classmethod
    def create(cls, config=None, device: str | torch.device = "cuda",
               **kwargs):
        """Create and configure, but do not initialize (pyx:286-320)."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        if config is None:
            config = Config(**kwargs)
        elif not isinstance(config, Config):
            config = Config(config)
        self._config = config
        config.expand()
        return self

    @property
    def config(self) -> Config:
        return self._config

    def initialize(self):
        """decoder_reinit (decoder.c:466-486): build everything from the
        current configuration."""
        config = self._config
        if config["loglevel"] and \
                config["loglevel"].upper() not in _LOGLEVELS:
            raise RuntimeError(f"Invalid loglevel {config['loglevel']}")
        if config["loglevel"]:
            # err_set_loglevel_str equivalent (err.c:51-60)
            lvl = config["loglevel"].upper()
            lvl = {"WARN": "WARNING", "FATAL": "CRITICAL"}.get(lvl, lvl)
            LOG.setLevel(getattr(logging, lvl))
        try:
            self.lmath = LogMath(config.get_float("logbase"), 0, True)
            self.am = AcousticModel.load(config, self.lmath)
            self.dict = Dictionary(
                self.am.mdef, config["dict"], config["fdict"],
                config.get_bool("dictcase"),
            )
            self.d2p = Dict2Pid(self.am.mdef, self.dict)
            self.reinit_feat()
            if config["mllr"]:
                self.update_mllr(config["mllr"])
            self.scorer = MsScorerNp(self.am) if self.am.backend == "ms" \
                else ScorerNp(self.am)
            self.search: FsgSearch | None = None
            self.align_search: StateAlignSearch | None = None
            self._feats: np.ndarray | None = None
            self._senscr_cache: dict[int, np.ndarray] = {}
            self._live = None
            self._cmn_live = None
            self._last_batch_mean = None
            self.output_frame = 0
            self._grammar_from_config()
        except RuntimeError:
            raise
        except Exception as e:
            # The reference surfaces all init failures as RuntimeError
            # (pyx initialize(), decoder_reinit NULL returns)
            raise RuntimeError(str(e)) from e

    # -- grammar setters (decoder.c:560-735) -------------------------------

    def _grammar_from_config(self):
        c = self.config
        if c["fsg"]:
            self.set_fsg_file(c["fsg"])
        elif c["jsgf"]:
            self.set_jsgf_file(c["jsgf"])

    def set_fsg(self, fsg: FsgModel):
        try:
            self.search = FsgSearch(fsg, self.config, self.am, self.dict,
                                    self.d2p, self.lmath)
        except ValueError as e:
            raise RuntimeError(str(e)) from e
        self.align_search = None

    def read_fsg(self, filename: str) -> FsgModel:
        """Read a grammar from an FSG file (pyx:556-575)."""
        return FsgModel.read_fsg_file(filename, self.lmath,
                                      self.config.get_float("lw"))

    def read_jsgf(self, filename: str) -> FsgModel:
        """Read a JSGF grammar (pyx:577-597)."""
        jsgf = Jsgf.parse_file(filename)
        rule = jsgf.get_rule(self.config["toprule"]) if self.config["toprule"] \
            else jsgf.default_rule()
        return jsgf.build_fsg(rule, self.lmath, self.config.get_float("lw"))

    def create_fsg(self, name, start_state, final_state, transitions):
        """Create an FSG from a transition list (pyx:599-660)."""
        import itertools

        n_state = max(itertools.chain(
            *((t[0], t[1]) for t in transitions))) + 1
        lw = self.config.get_float("lw")
        fsg = FsgModel(name, self.lmath, lw, n_state)
        fsg.start_state = start_state
        fsg.final_state = final_state
        for t in transitions:
            source, dest, prob = t[0:3]
            logp = int(self.lmath.log(prob) * lw)
            if len(t) > 3:
                wid = fsg.word_add(t[3])
                fsg.trans_add(source, dest, logp, wid)
            else:
                fsg.null_trans_add(source, dest, logp)
        return fsg

    def set_fsg_file(self, path: str):
        fsg = FsgModel.read_fsg_file(path, self.lmath,
                                     self.config.get_float("lw"))
        self.set_fsg(fsg)

    def set_jsgf_file(self, path: str):
        jsgf = Jsgf.parse_file(path)
        rule = jsgf.get_rule(self.config["toprule"]) if self.config["toprule"] \
            else jsgf.default_rule()
        fsg = jsgf.build_fsg(rule, self.lmath, self.config.get_float("lw"))
        self.set_fsg(fsg)

    def set_jsgf_string(self, text: str):
        jsgf = Jsgf.parse_string(text)
        rule = jsgf.get_rule(self.config["toprule"]) if self.config["toprule"] \
            else jsgf.default_rule()
        fsg = jsgf.build_fsg(rule, self.lmath, self.config.get_float("lw"))
        self.set_fsg(fsg)

    def set_align_text(self, text: str):
        """decoder_set_align_text (decoder.c:685-735): linear word chain."""
        words = text.split()
        for w in words:
            if self.dict.wordid(w) < 0:
                raise KeyError(f"Unknown word {w}")
        fsg = FsgModel(text, self.lmath, self.config.get_float("lw"),
                       len(words) + 1)
        for i, w in enumerate(words):
            wid = fsg.word_add(w)
            fsg.trans_add(i, i + 1, 0, wid)
        fsg.start_state = 0
        fsg.final_state = len(words)
        self.set_fsg(fsg)

    def add_word(self, word: str, phones: str, update: bool = True) -> int:
        """decoder_add_word (decoder.c:800-877)."""
        pron = []
        for ph in phones.split():
            pid = self.am.mdef.ciphone_id(ph)
            if pid < 0:
                raise KeyError(f"Unknown phone {ph}")
            pron.append(pid)
        wid = self.dict.add_word(word, pron)
        if wid >= 0:
            self.d2p.add_word(wid)
        return wid

    def update_mllr(self, path: str):
        """acmod_update_mllr (acmod.c:316-325): apply an MLLR transform to
        the Gaussian parameters."""
        from .mllr import Mllr, apply_mllr

        apply_mllr(self.am, Mllr(path), self.config)
        if hasattr(self, "scorer"):
            self.scorer = MsScorerNp(self.am) if self.am.backend == "ms" \
                else ScorerNp(self.am)

    def lookup_word(self, word: str) -> str | None:
        wid = self.dict.wordid(word)
        if wid < 0:
            return None
        return " ".join(self.am.mdef.ciphone_str(p)
                        for p in self.dict.prons[wid])

    # -- utterance processing (full-utterance path) ------------------------

    def start_utt(self):
        if self.search is None:
            raise RuntimeError("No search module initialized")
        self._feats = None
        self._senscr_cache = {}
        self.output_frame = 0
        self.scorer.start_utt()
        self.search.start()
        self.align_search = None
        self._live = None
        # ptmr_start on the perf timers (decoder.c:905-907)
        self._utt_wall0 = time.perf_counter()
        self._utt_cpu0 = time.process_time()

    def process_raw(self, audio, no_search=False, full_utt=True):
        """decoder_process_int16 (decoder.c:959-1031): full-utterance or
        chunked (streaming) processing.

        audio: int16 numpy array, raw bytes (interpreted as int16 like the
        reference binding), or float32 in [-1,1) which is scaled by 32768
        like fe_process_float32."""
        if isinstance(audio, (bytes, bytearray, memoryview)):
            audio = np.frombuffer(audio, dtype=np.int16)
        audio = np.asarray(audio)
        rng = getattr(self, "_dither_rng", None)
        if audio.dtype == np.int16:
            if rng is not None:
                audio = rng.dither_int16(audio)
            sig = audio.astype(np.float32)
        elif audio.dtype in (np.float32, np.float64):
            if rng is not None:
                sig = rng.dither_float32(audio, 32768.0)
            else:
                sig = (audio.astype(np.float32) * np.float32(32768.0))
        else:
            raise TypeError(f"Unsupported audio dtype {audio.dtype}")
        if not full_utt:
            return self._process_live(sig, no_search)
        cep = self._fe_process(sig)
        if self.config["cmn"] in ("batch", "current") and len(cep):
            from .fe.feat import cmn_batch_np

            cep, mean = cmn_batch_np(cep)
            self._last_batch_mean = mean
            feats = self.featpipe.compute_full(cep, cmn_mode="none")
        else:
            feats = self.featpipe.compute_full(
                cep, cmn_mode=self.config["cmn"])
        self._feats = feats
        if not no_search:
            self._run_search()
        return len(feats)

    # -- live/chunked path (acmod.c:528-689 semantics) ---------------------

    def _live_state(self):
        if self._live is None:
            from .fe.cmn_live import CmnLive

            if not hasattr(self, "_cmn_live") or self._cmn_live is None:
                # live CMN persists ACROSS utterances (cmn_live.c), seeded
                # from cmninit (feat.c:886-892)
                self._cmn_live = CmnLive(self.fe.num_cepstra,
                                         self.config["cmninit"])
            self._live = dict(
                raw=np.zeros(0, np.float32),
                fe_frames=0,
                noise_state=None,
                cepq=[],        # normalized cep frames incl. head replicas
                head_done=False,
                nfeat_done=0,
                feats=[],
                no_search=False,
            )
        return self._live

    def _live_fe(self, st, first: int, count: int, tail: bool = False):
        """Compute frames [first, first+count) from the raw buffer."""
        shift, size = self.fe.frame_shift, self.fe.frame_size
        start = first * shift
        if tail:
            seg = st["raw"][start:]
        else:
            seg = st["raw"][start:(first + count - 1) * shift + size]
        prior = np.float32(st["raw"][start - 1]) if start > 0 else np.float32(0)
        n = len(seg)
        Tpad = max(128, -(-count // 128) * 128)
        # bucket the sample axis: distinct signal lengths are fresh jit
        # shapes (expensive compiles); n_samps masking handles padding
        Npad = max(2048, -(-n // 2048) * 2048)
        segp = np.zeros(Npad, np.float32)
        segp[:n] = seg
        if st["noise_state"] is None:
            st["noise_state"] = self.fe.noise_init(device=self.device)
        cep, st["noise_state"] = self.fe.mfcc_chunk(
            to_device(segp, np.float32, self.device), n, Tpad, prior,
            st["noise_state"], count)
        return cep[:count].cpu().numpy()

    def _process_live(self, sig: np.ndarray, no_search: bool) -> int:
        st = self._live_state()
        st["no_search"] = no_search
        st["raw"] = np.concatenate([st["raw"], sig])
        N = len(st["raw"])
        size, shift = self.fe.frame_size, self.fe.frame_shift
        ntotal = 1 + (N - size) // shift if N >= size else 0
        new = ntotal - st["fe_frames"]
        if new > 0:
            cep = self._live_fe(st, st["fe_frames"], new)
            st["fe_frames"] = ntotal
            self._live_push_cep(st, cep)
        return self._live_compute_feats(st)

    def _live_push_cep(self, st, cep: np.ndarray):
        norm = self._cmn_live.process(cep)
        if not st["head_done"] and len(norm) > 0:
            # begin-of-utterance replication (feat_s2mfc2feat_live,
            # feat.c:1057-1067): window_size copies of the first frame
            for _ in range(self.featpipe.window_size):
                st["cepq"].append(norm[0].copy())
            st["head_done"] = True
        for row in norm:
            st["cepq"].append(row)

    def _live_compute_feats(self, st) -> int:
        w = self.featpipe.window_size
        navail = len(st["cepq"]) - 2 * w
        nnew = navail - st["nfeat_done"]
        if nnew <= 0:
            return 0
        for i in range(st["nfeat_done"], navail):
            win = np.stack(st["cepq"][i:i + 2 * w + 1])
            st["feats"].append(self.featpipe.compute_window(win))
        st["nfeat_done"] = navail
        self._feats = np.stack(st["feats"])
        if not st["no_search"]:
            while self.output_frame < len(self._feats):
                t = self.output_frame
                senscr = self._score_frame(t, self.search)
                self.search.step(senscr, t)
                self.output_frame = t + 1
                self.scorer.frame_idx = t + 1
        return nnew

    def _fe_process(self, sig: np.ndarray) -> np.ndarray:
        n = len(sig)
        nfr = self.fe.n_frames(n)
        if nfr == 0:
            return np.zeros((0, self.fe.num_cepstra), np.float32)
        out = self.fe.mfcc(to_device(sig, np.float32, self.device), n, nfr)
        return out[:nfr].cpu().numpy()

    def _score_frame(self, frame: int, search) -> np.ndarray:
        """acmod_score equivalent with senone-active bookkeeping."""
        if self.config.get_bool("compallsen"):
            if frame in self._senscr_cache:
                return self._senscr_cache[frame]
            scr = self.scorer.frame_eval(self._feats[frame], frame, None, None)
            self._senscr_cache = {frame: scr}
            return scr
        # fsg_search_sen_active clears the acmod bitvec each frame
        # (acmod_clear_active, fsg_search.c:309-311)
        self._active_vec = set(search.sen_active())
        sens = senone_flags2list(self._active_vec)
        mgau_active = np.zeros(self.am.n_mgau, bool)
        mgau_active[self.am.sen2cb[sens]] = True
        if hasattr(search, "n_sen_eval"):
            search.n_sen_eval += len(sens)  # fsg_search.c:831 counter
        return self.scorer.frame_eval(self._feats[frame], frame,
                                      mgau_active, sens)

    def _run_search(self):
        feats = self._feats
        for t in range(len(feats)):
            senscr = self._score_frame(t, self.search)
            self.search.step(senscr, t)
            self.output_frame = t + 1
            self.scorer.frame_idx = t + 1

    def end_utt(self):
        if self._live is not None:
            self._end_live()
        self.search.finish()
        # Perf accounting (decoder.c:1044-1061 + fsg_search_finish's xRT
        # report, fsg_search.c:828-848): per-utterance and lifetime
        # speech/CPU/wall seconds, plus search-effort counters.
        wall = time.perf_counter() - getattr(self, "_utt_wall0",
                                             time.perf_counter())
        cpu = time.process_time() - getattr(self, "_utt_cpu0",
                                            time.process_time())
        frate = self.config.get_int("frate")
        n_frames = len(self._feats) if self._feats is not None else 0
        speech = n_frames / frate
        self._utt_speech, self._utt_cpu, self._utt_wall = speech, cpu, wall
        self._all_speech = getattr(self, "_all_speech", 0.0) + speech
        self._all_cpu = getattr(self, "_all_cpu", 0.0) + cpu
        self._all_wall = getattr(self, "_all_wall", 0.0) + wall
        if speech > 0:
            n_hmm = getattr(self.search, "n_hmm_eval", 0)
            n_sen = getattr(self.search, "n_sen_eval", 0)
            LOG.info(
                "%d frames, %d HMMs (%d/fr), %d senones (%d/fr)",
                n_frames, n_hmm, n_hmm // max(1, n_frames),
                n_sen, n_sen // max(1, n_frames))
            LOG.info("%.2f wall %.2f xRT, %.2f CPU %.2f xRT",
                     wall, wall / speech, cpu, cpu / speech)

    def set_logfile(self, path: str | None):
        """decoder_set_logfile (decoder.c:201-228): route this package's
        log output to a file (None restores stderr-only)."""
        for h in list(LOG.handlers):
            if getattr(h, "_sst_logfile", False):
                LOG.removeHandler(h)
                h.close()
        if path is not None:
            h = logging.FileHandler(path)
            h._sst_logfile = True
            h.setFormatter(logging.Formatter(
                "%(levelname)s: %(message)s"))
            LOG.addHandler(h)

    def utt_time(self):
        """decoder_utt_time (decoder.c:1252-1262): (speech, cpu, wall)
        seconds for the most recent utterance."""
        return (getattr(self, "_utt_speech", 0.0),
                getattr(self, "_utt_cpu", 0.0),
                getattr(self, "_utt_wall", 0.0))

    def all_time(self):
        """decoder_all_time (decoder.c:1264-1274): lifetime
        (speech, cpu, wall) seconds."""
        return (getattr(self, "_all_speech", 0.0),
                getattr(self, "_all_cpu", 0.0),
                getattr(self, "_all_wall", 0.0))

    def _end_live(self):
        """Flush the live pipeline: fe_end tail frame, end-of-utterance
        replication, remaining search steps, live-CMN fold
        (acmod_end_utt + feat endutt path)."""
        st = self._live
        N = len(st["raw"])
        shift = self.fe.frame_shift
        tail = N - st["fe_frames"] * shift
        if tail > 0 and N > 0:
            cep = self._live_fe(st, st["fe_frames"], 1, tail=True)
            st["fe_frames"] += 1
            self._live_push_cep(st, cep)
        if st["cepq"]:
            last = st["cepq"][-1]
            for _ in range(self.featpipe.window_size):
                st["cepq"].append(last.copy())
        self._live_compute_feats(st)
        self._cmn_live.update()

    @property
    def n_frames(self) -> int:
        return self.output_frame + 1

    # -- results -----------------------------------------------------------

    def _hyp_text_score(self):
        if self.align_search is not None:
            return self.align_search.hyp()
        if self.search is None:
            return None, 0
        return self.search.hyp()

    @property
    def hyp(self):
        """Current recognition hypothesis as a Hyp namedtuple
        (pyx:468-487): text, score and prob are probabilities via
        logmath_exp."""
        from . import Hyp

        text, score = self._hyp_text_score()
        if text is None:
            return Hyp(text=None, score=0.0, prob=0.0)
        return Hyp(text=text, score=self.lmath.exp(int(score)),
                   prob=self.lmath.exp(self.prob))

    @property
    def seg(self):
        """Current word segmentation as Seg namedtuples (pyx:530-554):
        times in seconds, scores as probabilities."""
        from . import Seg

        frate = self.config.get_int("frate")
        for s in self.seg_iter():
            if s["word"] is None:
                continue
            yield Seg(text=s["word"], start=s["sf"] / frate,
                      duration=(s["ef"] + 1 - s["sf"]) / frate,
                      ascore=self.lmath.exp(int(s["ascr"])),
                      lscore=self.lmath.exp(int(s["lscr"])))

    @property
    def prob(self) -> int:
        return 0  # fsg_search_prob without bestpath (fsg_search.c:1160-1162)

    def seg_iter(self):
        return self.search.seg_iter()

    def alignment(self) -> Alignment | None:
        """decoder_alignment (decoder.c:737-798): two-pass alignment."""
        if self.align_search is not None and \
                self.align_search.frame == self.output_frame:
            return self.align_search.al
        segs = self.search.seg_iter()
        if not segs:
            return None
        al = Alignment(self.d2p)
        prev_ef = -1
        for seg in segs:
            if seg["word"] is None:
                continue
            wid = self.dict.wordid(seg["word"])
            if wid < 0:
                continue
            assert seg["sf"] == prev_ef + 1
            prev_ef = seg["ef"]
            al.add_word(wid, seg["sf"], seg["ef"] - seg["sf"] + 1)
        al.populate()
        sas = StateAlignSearch(self.am, al)
        # acmod_rewind: replay buffered features through the second pass
        self.scorer.frame_idx = 0
        sas.start()
        for t in range(self.output_frame):
            senscr = self._score_frame_align(t, sas)
            sas.step(senscr, t)
            self.scorer.frame_idx = t + 1
        if sas.finish() < 0:
            return None
        self.align_search = sas
        return al

    def _score_frame_align(self, frame: int, sas) -> np.ndarray:
        if self.config.get_bool("compallsen"):
            return self.scorer.frame_eval(self._feats[frame], frame, None, None)
        # Reference quirk: only the FSG search ever calls
        # acmod_clear_active, so during the second (state-align) pass the
        # active-senone bitvec ACCUMULATES across frames, seeded with
        # pass-1's final frame (state_align_search_step only activates,
        # state_align_search.c:186-188).  Replicated for exact parity of
        # per-frame normalization (and hence alignment scores).
        self._active_vec |= sas.active_senones()
        sens = senone_flags2list(self._active_vec)
        mgau_active = np.zeros(self.am.n_mgau, bool)
        mgau_active[self.am.sen2cb[sens]] = True
        return self.scorer.frame_eval(self._feats[frame], frame,
                                      mgau_active, sens)

    # -- JSON result (decoder.c:1340-1593) ---------------------------------

    def result_json(self, start: float = 0.0, align_level: int = 0) -> str:
        lmath = self.lmath
        frate = self.config.get_int("frate")
        duration = self.n_frames / frate

        def fmt(b, d, p, t):
            return f'{{"b":{b:.3f},"d":{d:.3f},"p":{p:.3f},"t":"{t}"'

        hyp = self._hyp_text_score()[0] or ""
        out = [fmt(start, duration, lmath.exp(self.prob), hyp)]
        out.append(',"w":[')
        if align_level:
            al = self.alignment()
            if al is None:
                return None
            first = True
            for i, went in enumerate(al.words):
                if not first:
                    out.append(",")
                first = False
                out.append(fmt(start + went.start / frate,
                               went.duration / frate,
                               lmath.exp(went.score),
                               self.dict.wordstr(went.id)))
                out.append(',"w":[')
                phones = [(j, p) for j, p in enumerate(al.phones)
                          if p.parent == i]
                pfirst = True
                for j, pent in phones:
                    if not pfirst:
                        out.append(",")
                    pfirst = False
                    out.append(fmt(start + pent.start / frate,
                                   pent.duration / frate,
                                   lmath.exp(pent.score),
                                   self.am.mdef.ciphone_str(pent.id[0])))
                    if align_level > 1:
                        out.append(',"w":[')
                        states = [s for s in al.states if s.parent == j]
                        sfirst = True
                        for sent in states:
                            if not sfirst:
                                out.append(",")
                            sfirst = False
                            out.append(fmt(start + sent.start / frate,
                                           sent.duration / frate,
                                           lmath.exp(sent.score),
                                           str(sent.id)))
                            out.append("}")
                        out.append("]")
                    out.append("}")
                out.append("]}")
        else:
            first = True
            for seg in self.seg_iter():
                if not first:
                    out.append(",")
                first = False
                word = seg["word"] or ""
                out.append(fmt(start + seg["sf"] / frate,
                               (seg["ef"] + 1 - seg["sf"]) / frate,
                               lmath.exp(seg["prob"]), word))
                out.append("}")
        out.append("]}\n")
        return "".join(out)

    # -- lattice / nbest (decoder.c:1145-1244) -----------------------------

    def lattice(self):
        """decoder_lattice: word DAG from the FSG search history."""
        from .lattice import Lattice

        if self.search is None:
            return None
        return Lattice.from_fsg_search(self.search, self.config)

    def nbest(self, sf: int = 0, ef: int = -1):
        """decoder_nbest: A* N-best hypothesis iterator yielding
        (hyp_string, score) best-first."""
        from .lattice import AstarSearch

        dag = self.lattice()
        if dag is None:
            return
        astar = AstarSearch(dag, sf, ef)
        while True:
            p = astar.next()
            if p is None:
                return
            yield astar.hyp(p), p.score

    # -- file decoding + serialization (pyx:734-798) -----------------------

    def decode_file(self, input_file: str):
        """Decode a single-channel WAV or raw file; returns (hyp, segs)
        like the reference binding (pyx:734-772)."""
        from . import get_audio_data

        data, sample_rate = get_audio_data(input_file)
        if sample_rate is None:
            sample_rate = self.config.get_int("samprate")
        if sample_rate != self.config.get_int("samprate"):
            self.config["samprate"] = sample_rate
            self.reinit_feat()
        audio = np.frombuffer(data, dtype=np.int16)
        self.start_utt()
        self.process_raw(audio)
        self.end_utt()
        import collections

        Seg = collections.namedtuple(
            "Seg", ["text", "start", "duration", "ascore", "lscore"])
        frate = self.config.get_int("frate")
        segs = [
            Seg(s["word"], s["sf"] / frate, (s["ef"] + 1 - s["sf"]) / frate,
                self.lmath.exp(int(s["ascr"])), self.lmath.exp(int(s["lscr"])))
            for s in self.seg_iter() if s["word"] is not None
        ]
        return self._hyp_text_score()[0], segs

    def dumps(self, start: float = 0.0, align_level: int = 0) -> str:
        """decoder_result_json as a str (pyx ``dumps``)."""
        return self.result_json(start, align_level)

    def spectrogram(self, audio: np.ndarray,
                    smooth: bool = False) -> np.ndarray:
        """Mel log-spectra [n_frames, nfilt] float32 for visualization —
        the JS binding's spectrogram() (js/soundswallower.c:88-112,
        js/api.js:505): raw log mel spectrum, or cepstrally smoothed
        (DCT-II/DCT-III round trip) when ``smooth``; on the decoder's
        device."""
        return self.fe.spectrogram(audio, smooth, device=self.device)

    def reinit_feat(self):
        """decoder_reinit_feat: rebuild the front end from config
        (raises RuntimeError on invalid FE parameters, pyx:360-370)."""
        c = self.config
        if c.get_float("upperf") > c.get_int("samprate") / 2 + 1.0:
            # fe_init check (fe_interface.c:299-305)
            raise RuntimeError(
                f"Upper frequency {c['upperf']} is higher than samprate/2")
        self.fe = Frontend(
            sampling_rate=c.get_int("samprate"),
            frame_rate=c.get_int("frate"),
            window_length=c.get_float("wlen"),
            fft_size=c.get_int("nfft"),
            num_cepstra=c.get_int("ncep"),
            num_filters=c.get_int("nfilt"),
            lower_filt_freq=c.get_float("lowerf"),
            upper_filt_freq=c.get_float("upperf"),
            pre_emphasis_alpha=c.get_float("alpha"),
            lifter_val=c.get_int("lifter"),
            transform=c["transform"],
            warp_type=c["warp_type"] or "inverse_linear",
            warp_params=c["warp_params"],
            remove_noise=c.get_bool("remove_noise"),
            remove_dc=c.get_bool("remove_dc"),
        )
        # feat_init (feat.c:732-927): feature-type registry + LDA +
        # subvector specification
        lda = None
        if c["lda"]:
            from .s3file import read_lda

            lda = read_lda(c["lda"])
        self.featpipe = FeatPipeline(
            c["feat"] or "1s_c_d_dd",
            cepsize=c.get_int("ceplen") or 13,
            lda=lda, ldadim=c.get_int("ldadim"),
            svspec=c["svspec"])
        # fe_init_dither (fe_interface.c:283-284,345-349): seeded once at
        # FE construction; one rand31 draw per incoming sample in stream
        # order (fe_read_frame*/fe_shift_frame*, fe_sigproc.c:330-440).
        if c.get_bool("dither"):
            from .genrand import GenRand

            self._dither_rng = GenRand(c.get_int("seed"))
        else:
            self._dither_rng = None

    # -- CMN state (decoder.c:488-516) -------------------------------------

    def get_cmn(self, update: bool = False) -> str:
        """decoder_get_cmn (decoder.c:488-500): serialize the CMN state."""
        from .fe.cmn_live import CmnLive

        if getattr(self, "_cmn_live", None) is None:
            self._cmn_live = CmnLive(self.fe.num_cepstra,
                                     self.config["cmninit"])
        if getattr(self, "_last_batch_mean", None) is not None:
            return ",".join("%g" % float(x) for x in self._last_batch_mean)
        if update:
            self._cmn_live.update()
        return self._cmn_live.repr()

    def set_cmn(self, repr_str: str):
        """decoder_set_cmn (decoder.c:502-516)."""
        from .fe.cmn_live import CmnLive

        if getattr(self, "_cmn_live", None) is None:
            self._cmn_live = CmnLive(self.fe.num_cepstra)
        self._cmn_live.set_repr(repr_str)
