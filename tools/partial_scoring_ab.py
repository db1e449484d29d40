"""Interleaved A/B of full-vocab vs partial CTC prefix scoring in the
joint beam, at a BPE-sized vocab — the value case the serving defaults
assert but round 3 never measured [VERDICT.md round-3 weak #6 / item 5].

Partial scoring (decode.ctc_score_candidates=N) narrows the per-step
CTC prefix-score scan from V columns to N attention-ranked candidates.
At char vocab (V=32) it is a measured wash; its claimed value cases are
BPE+ vocabs, where the full-vocab prefix state row is V-wide per (beam,
frame). This harness measures both variants in ONE process, alternating
them per batch so both see the same conditions:

- wall time per batch call (the call returns host-side texts, so the
  device work is complete when it returns),
- executed beam steps, and output WER equality/divergence.

Usage::

    python tools/partial_scoring_ab.py --config configs/english_m5_bpe.yaml \
        --ckpt runs/english_bpe/ckpts_english_m5/best.msgpack --n-cand 20
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gluon_e2e_asr.config import apply_overrides, load_config  # noqa: E402
from gluon_e2e_asr.data.loader import DataLoader  # noqa: E402
from gluon_e2e_asr.data.sampler import (  # noqa: E402
    BucketSampler,
    make_bucket_specs,
)
from gluon_e2e_asr.data.tokenizer import (  # noqa: E402
    CharTokenizer,
    tokenizer_from_json,
)
from gluon_e2e_asr.decoding.beam import make_beam_decoder  # noqa: E402
from gluon_e2e_asr.eval.metrics import wer  # noqa: E402
from gluon_e2e_asr.models.asr import build_model  # noqa: E402
from gluon_e2e_asr.training.checkpoint import restore_checkpoint  # noqa: E402
from gluon_e2e_asr.training.train_step import (  # noqa: E402
    create_template_state,
    make_optimizer,
)
from gluon_e2e_asr.training.trainer import build_datasets  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--n-cand", type=int, default=20)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = p.parse_args(argv)

    config = load_config(args.config)
    apply_overrides(config, args.set)
    config.decode.method = "beam"

    tokenizer = CharTokenizer()
    meta_path = args.ckpt + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            m0 = json.load(f)
        if m0.get("vocab"):
            tokenizer = tokenizer_from_json(m0["vocab"])
    _, dev_utts = build_datasets(config)
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch,
    )
    sampler = BucketSampler(dev_utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    loader = DataLoader(dev_utts, sampler, tokenizer,
                        config.data.sample_rate,
                        transfer_dtype=config.data.transfer_dtype)
    model = build_model(config, tokenizer.vocab_size, tokenizer.sos_id,
                        tokenizer.eos_id)
    first = next(iter(loader.epoch(0)))
    template = create_template_state(
        config, model, make_optimizer(config),
        {"audio": first.audio, "audio_len": first.audio_len,
         "labels": first.labels, "label_len": first.label_len},
    )
    state, cmvn_stats, _ = restore_checkpoint(args.ckpt, template,
                                              params_only=True)

    cfg_full = copy.deepcopy(config)
    cfg_full.decode.ctc_score_candidates = 0
    cfg_part = copy.deepcopy(config)
    cfg_part.decode.ctc_score_candidates = args.n_cand
    variants = {
        "full": make_beam_decoder(model, cfg_full, tokenizer, cmvn_stats),
        "partial": make_beam_decoder(model, cfg_part, tokenizer, cmvn_stats),
    }

    wall = {k: [] for k in variants}
    steps = {k: [] for k in variants}
    hyps = {k: [] for k in variants}
    refs = []
    by_id = {u.utt_id: u for u in dev_utts}
    warmed = set()
    for b in loader.epoch(0):
        a, al = jnp.asarray(b.audio), jnp.asarray(b.audio_len)
        refs.extend(by_id[u].text for u in b.utt_ids[: b.num_real])
        for name, dec in variants.items():
            key = (name, b.audio.shape[1])
            if key not in warmed:
                dec(state.params, a, al)
                warmed.add(key)
            t0 = time.perf_counter()
            texts, _ = dec(state.params, a, al)
            wall[name].append(time.perf_counter() - t0)
            steps[name].append(dec.last_steps)
            hyps[name].extend(texts[: b.num_real])

    out = {
        "vocab_size": tokenizer.vocab_size,
        "n_cand": args.n_cand,
        "batch_size": config.data.batch_size,
        "num_utts": len(refs),
    }
    for name in variants:
        ws = sorted(wall[name])
        tot_steps = sum(steps[name])
        out[name] = {
            "wall_p50_s": round(ws[len(ws) // 2], 4),
            "wall_ms_per_step": round(
                sum(wall[name]) * 1e3 / max(tot_steps, 1), 3),
            "beam_steps_total": int(tot_steps),
            "wer": round(wer(refs, hyps[name]), 4),
        }
    out["hyps_identical"] = hyps["full"] == hyps["partial"]
    out["full_over_partial_wall"] = round(
        out["full"]["wall_p50_s"] / out["partial"]["wall_p50_s"], 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
