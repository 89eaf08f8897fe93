"""Command-line interface, compatible with the reference ``soundswallower``
CLI (py/soundswallower/cli.py): takes audio files, outputs line-JSON time
alignments.

  soundswallower --align input.txt audio.wav
  soundswallower --align-text "hello world" audio.wav --phone-align
  soundswallower --grammar input.gram audio.wav
  soundswallower --fsg input.fsg audio.wav
  soundswallower --model fr-fr ...

By default alignment/decoding rides the fast path on the card
(TorchAligner: one batched dispatch over all input files, kernels
K1-K7).  ``--exact`` switches to the bit-exact reference-parity decoder
(Decoder: the two-pass FSG + state alignment, its front end on the card),
which also serves ``--state-align`` (the fast path reports word + phone
levels).  A copy of the JAX package's CLI; the command line runs on the
card, and ``main(argv, device)`` takes the device for the tests.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from . import get_audio_data, get_model_path
from .config import Config
from .decoder import Decoder


def make_argparse() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("inputs", nargs="*", help="Input files.")
    parser.add_argument("--help-config", action="store_true",
                        help="Print help for decoder configuration parameters.")
    parser.add_argument("--dict", help="Custom dictionary file.")
    parser.add_argument("--model", default="en-us",
                        help="Specific model, built-in or from directory.")
    parser.add_argument("--config", help="JSON file with decoder configuration.")
    parser.add_argument("-s", "--set", action="append",
                        help="Set configuration parameter (KEY=VALUE).")
    parser.add_argument("--write-config",
                        help="Write full configuration as JSON to OUTPUT and exit.")
    parser.add_argument("-o", "--output",
                        help="Filename for output (default is standard output)")
    parser.add_argument("-v", "--verbose", action="store_true", help="Be verbose.")
    parser.add_argument("--phone-align", action="store_true",
                        help="Produce phone-level alignments")
    parser.add_argument("--state-align", action="store_true",
                        help="Produce state-level alignments (exact path)")
    parser.add_argument("--exact", action="store_true",
                        help="Use the bit-exact reference-parity decoder "
                             "instead of the fast path")
    grammars = parser.add_mutually_exclusive_group()
    grammars.add_argument("-a", "--align", help="Input text file for force alignment.")
    grammars.add_argument("-t", "--align-text", help="Input text for force alignment.")
    grammars.add_argument("-g", "--grammar", help="Grammar file for recognition.")
    grammars.add_argument("-f", "--fsg", help="FSG file for recognition.")
    return parser


def make_decoder_config(args: argparse.Namespace) -> Config:
    config = Config()
    if args.config is not None:
        with open(args.config) as fh:
            config.parse_json(fh.read())
    model_path = get_model_path()
    if args.model in os.listdir(model_path):
        config["hmm"] = os.path.join(model_path, args.model)
    else:
        config["hmm"] = args.model
    if args.dict is not None:
        config["dict"] = args.dict
    if args.grammar is not None:
        config["jsgf"] = args.grammar
    if args.fsg is not None:
        config["fsg"] = args.fsg
    if args.verbose:
        config["loglevel"] = "INFO"
        config["backtrace"] = True
    if args.set:
        for kv in args.set:
            key, value = kv.split("=")
            config[key] = value
    return config


def print_config_help(config: Config) -> None:
    print("Configuration parameters:")
    for name, typ, dflt, hlp in config.describe():
        print("\t%s (%s%s):\n\t\t%s"
              % (name, typ, (", default: %s" % dflt) if dflt else "", hlp))


def main(argv: Optional[Sequence[str]] = None,
         device: str | torch.device = "cuda") -> None:
    logging.basicConfig(level=logging.INFO)
    parser = make_argparse()
    args = parser.parse_args(argv)
    config = make_decoder_config(args)
    if args.help_config:
        print_config_help(config)
        sys.exit(0)
    if args.write_config is not None:
        out = sys.stdout if args.write_config == "-" else open(args.write_config, "w")
        out.write(config.serialize_json())
        if out is not sys.stdout:
            out.close()
        return
    if args.align:
        with open(args.align) as fh:
            args.align_text = fh.read().strip()
    elif args.grammar or args.fsg or args.align_text:
        pass
    else:
        return  # Nothing to do!
    # reference behavior: align_level = bool(phone_align) (cli.py:166);
    # --state-align is our extension for level 2 (fast path emits the
    # state level directly from its Viterbi path; --exact for the
    # byte-identical two-pass JSON)
    align_level = 2 if args.state_align else (1 if args.phone_align else 0)
    if args.exact:
        results = _run_exact(config, args, align_level, device)
    else:
        results = _run_fast(config, args, align_level, device)
    if args.output is not None:
        with open(args.output, "w") as outfh:
            for json_line in results:
                outfh.write(json_line)
    else:
        for json_line in results:
            print(json_line, end="")


def _run_exact(config: Config, args, align_level: int, device) -> list:
    """Reference-parity path: the two-pass Decoder (byte-identical
    result JSON vs the C library; its search and scoring take minutes
    per utterance on the host)."""
    decoder = Decoder(config, device=device)
    if args.align_text is not None:
        decoder.set_align_text(args.align_text)
    results = []
    for input_file in args.inputs:
        decoder.decode_file(input_file)
        results.append(decoder.dumps(align_level=align_level))
    return results


def _run_fast(config: Config, args, align_level: int, device) -> list:
    """Fast path on the card: all input files of one sample rate go
    through ONE batched dispatch (align_batch_scored /
    decode_batch_scored), output in the same line-JSON schema as the
    reference CLI."""
    from .aligner import TorchAligner, result_json_from_segs

    loaded = []
    for input_file in args.inputs:
        data, rate = get_audio_data(input_file)
        loaded.append((np.frombuffer(data, np.int16), rate))
    results: list = [None] * len(loaded)
    # group by sample rate (one aligner/FE per rate; raw files inherit
    # the configured rate like decoder_process defaults)
    by_rate: dict = {}
    for i, (_, rate) in enumerate(loaded):
        by_rate.setdefault(rate, []).append(i)
    for rate, idxs in by_rate.items():
        if rate is not None:
            config["samprate"] = rate
        al = TorchAligner(config, device=device)
        if align_level >= 2:
            al.want_states = True
        frate = al.config.get_int("frate")
        audios = [loaded[i][0] for i in idxs]
        if args.align_text is not None:
            segs_list = al.align_batch_scored(
                audios, [args.align_text] * len(audios))
            outs = []
            for segs in segs_list:
                if segs is None:
                    raise RuntimeError("Alignment failed")
                outs.append((None, segs))
        else:
            if args.grammar:
                al.set_grammar(jsgf_file=args.grammar)
            else:
                from .fsg import FsgModel
                fsg = FsgModel.read_fsg_file(
                    args.fsg, al.lmath, al.config.get_float("lw"))
                al.set_grammar(fsg=fsg)
            outs = []
            for res in al.decode_batch_scored(audios):
                if res is None:
                    raise RuntimeError("Decode failed")
                outs.append(res)
        for i, (hyp, segs) in zip(idxs, outs):
            # top-level duration counts output_frame + 1 like the
            # reference (decoder_result_json via decoder_n_frames):
            # one more than the feature frame count
            n_frames = segs[-1].start + segs[-1].duration + 1 if segs else 0
            results[i] = result_json_from_segs(
                segs, al.lmath, n_frames, frate, hyp=hyp,
                align_level=align_level)
    return results


def entry() -> None:
    """The console script: the command line, on the card."""
    main()


if __name__ == "__main__":
    entry()
