#!/usr/bin/env python
"""Grid-search decode knobs (beam) on a tune/holdout split of the dev set.

The reference family's decode quality hinges on a handful of search
knobs — ``decode.ctc_weight``, ``decode.penalty``, ``decode.beam_size``,
``decode.length_norm`` — that interact and are usually hand-tuned per
corpus [SURVEY.md §2.1 #17; BASELINE.json:L11]. This tool sweeps any of
them, scoring each combo's WER on a deterministic tune/holdout split of
the dev utterances (split by utt-id hash, so it is stable across runs
and configs). The holdout column is only read for the combo the tune
split selects — the honest protocol for claiming a tuned number.

Usage:
  python tools/tune_decode.py --config configs/milestone5_beam.yaml \
      --ckpt ckpts/best.msgpack \
      --grid ctc_weight=0.0,0.1,0.3,0.5 --grid penalty=0.0,0.3 \
      [--holdout-frac 0.5] [--output tune.jsonl]

Each combo re-jits the beam program (the knobs are trace constants by
design — they cost nothing per step on device), so a G-combo sweep pays
G compiles; the persistent compilation cache makes re-runs cheap.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

import jax.numpy as jnp  # noqa: E402

from gluon_e2e_asr.config import (  # noqa: E402
    Config,
    apply_overrides,
    load_config,
)
from gluon_e2e_asr.data.loader import DataLoader  # noqa: E402
from gluon_e2e_asr.data.sampler import (  # noqa: E402
    BucketSampler,
    make_bucket_specs,
)
from gluon_e2e_asr.data.tokenizer import CharTokenizer  # noqa: E402
from gluon_e2e_asr.decoding.beam import make_beam_decoder  # noqa: E402
from gluon_e2e_asr.eval.metrics import wer  # noqa: E402
from gluon_e2e_asr.models.asr import build_model  # noqa: E402
from gluon_e2e_asr.training.checkpoint import (  # noqa: E402
    restore_checkpoint,
)
from gluon_e2e_asr.training.train_step import (  # noqa: E402
    create_template_state,
    make_optimizer,
)
from gluon_e2e_asr.training.trainer import build_datasets  # noqa: E402

_BOOL = {"true": True, "false": False}


def _parse_grid(items):
    """--grid key=v1,v2,... (repeatable) -> {key: [typed values]}."""
    grid = {}
    for it in items:
        key, _, vals = it.partition("=")
        if not vals:
            raise SystemExit(f"--grid wants key=v1,v2,...; got {it!r}")
        typed = []
        for v in vals.split(","):
            lv = v.strip().lower()
            if lv in _BOOL:
                typed.append(_BOOL[lv])
            else:
                try:
                    typed.append(int(v))
                except ValueError:
                    typed.append(float(v))
        grid[key.strip()] = typed
    return grid


def in_holdout(utt_id: str, frac: float) -> bool:
    """Deterministic utt-id-hash split, stable across runs/configs."""
    return (zlib.crc32(utt_id.encode()) % 1000) < int(frac * 1000)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="grid-search beam decode knobs on a tune/holdout split")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--grid", action="append", default=[],
                    metavar="KEY=V1,V2,...",
                    help="decode.<KEY> values to sweep (repeatable)")
    ap.add_argument("--holdout-frac", type=float, default=0.5)
    ap.add_argument("--output", default="")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = ap.parse_args(argv)
    grid = _parse_grid(args.grid)
    if not grid:
        raise SystemExit("nothing to sweep: pass at least one --grid")

    config = load_config(args.config)
    apply_overrides(config, args.set)
    config.decode.method = "beam"

    tokenizer = CharTokenizer()
    _, dev_utts = build_datasets(config)
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch,
    )
    sampler = BucketSampler(dev_utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    loader = DataLoader(dev_utts, sampler, tokenizer, config.data.sample_rate,
                        transfer_dtype=config.data.transfer_dtype)
    model = build_model(config, tokenizer.vocab_size, tokenizer.sos_id,
                        tokenizer.eos_id)
    first = next(iter(loader.epoch(0)))
    template = create_template_state(
        config, model, make_optimizer(config),
        {"audio": first.audio, "audio_len": first.audio_len,
         "labels": first.labels, "label_len": first.label_len},
    )
    state, cmvn_stats, meta = restore_checkpoint(args.ckpt, template, params_only=True)
    if meta.get("vocab"):
        tokenizer = CharTokenizer.from_json(meta["vocab"])
    by_id = {u.utt_id: u for u in dev_utts}

    out_f = open(args.output, "w") if args.output else None
    rows = []
    keys = sorted(grid)
    for combo in itertools.product(*(grid[k] for k in keys)):
        cfg = copy.deepcopy(config)
        for k, v in zip(keys, combo):
            if not hasattr(cfg.decode, k):
                raise SystemExit(f"decode config has no knob {k!r}")
            setattr(cfg.decode, k, v)
        decoder = make_beam_decoder(model, cfg, tokenizer, cmvn_stats)
        split = {"tune": ([], []), "holdout": ([], [])}
        for b in loader.epoch(0):
            texts, _ = decoder(state.params, jnp.asarray(b.audio),
                               jnp.asarray(b.audio_len))
            for row, utt_id in enumerate(b.utt_ids):
                name = ("holdout"
                        if in_holdout(utt_id, args.holdout_frac) else "tune")
                split[name][0].append(by_id[utt_id].text)
                split[name][1].append(texts[row])
        rec = {"combo": dict(zip(keys, combo))}
        for name, (refs, hyps) in split.items():
            rec[f"{name}_wer"] = round(wer(refs, hyps), 4) if refs else None
            rec[f"{name}_n"] = len(refs)
        rows.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")

    best = min(rows, key=lambda r: r["tune_wer"])
    summary = {
        "event": "tune_decode_done",
        "grid": grid,
        "holdout_frac": args.holdout_frac,
        "best_by_tune": best["combo"],
        "tune_wer": best["tune_wer"],
        # The one honest generalization number: the holdout WER of the
        # combo the tune split picked (NOT the best holdout in the grid).
        "holdout_wer_of_best": best["holdout_wer"],
    }
    line = json.dumps(summary)
    print(line)
    if out_f:
        out_f.write(line + "\n")
        out_f.close()
    return summary


if __name__ == "__main__":
    main()
