"""Interleaved single-process A/B of B=1 decode variants.

Separate decode CLI runs can land on differently loaded hosts, so
cross-process B=1 latency comparisons are noisy. This harness builds
every variant's decoder in ONE process and alternates variants per
utterance, so each utterance contributes one timing to every variant
under identical conditions.

Variants:
  exact    — the batched beam program (full-vocab CTC scoring, no early
             stop) at batch 1
  serving  — the B=1 serving defaults (ctc_score_candidates=2K,
             end_detect)
  greedy   — CTC argmax collapse (no attention decoder)

Usage::

    python tools/b1_latency_ab.py --config configs/english_m5.yaml \
        --ckpt runs/english_base/ckpts_english_m5/best.msgpack --utts 48
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
from gluon_e2e_asr.data.tokenizer import CharTokenizer  # noqa: E402
from gluon_e2e_asr.decoding.beam import make_beam_decoder  # noqa: E402
from gluon_e2e_asr.decoding.greedy import (  # noqa: E402
    ids_to_texts,
    make_greedy_decoder,
)
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
    p.add_argument("--utts", type=int, default=48)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = p.parse_args(argv)

    config = load_config(args.config)
    apply_overrides(config, args.set)
    config.data.batch_size = 1
    config.decode.method = "beam"

    tokenizer = CharTokenizer()
    meta_path = args.ckpt + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            m0 = json.load(f)
        if m0.get("vocab"):
            from gluon_e2e_asr.data.tokenizer import tokenizer_from_json

            tokenizer = tokenizer_from_json(m0["vocab"])
    _, dev_utts = build_datasets(config)
    dev_utts = dev_utts[: args.utts]
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate, 1,
        config.data.max_label_len, config.frontend.hop_length, False,
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
    state, cmvn_stats, _ = restore_checkpoint(args.ckpt, template,
                                              params_only=True)

    cfg_exact = copy.deepcopy(config)
    cfg_exact.decode.end_detect = False
    cfg_exact.decode.ctc_score_candidates = 0
    cfg_serv = copy.deepcopy(config)
    cfg_serv.decode.end_detect = True
    cfg_serv.decode.ctc_score_candidates = 2 * config.decode.beam_size
    variants = {
        "exact": make_beam_decoder(model, cfg_exact, tokenizer, cmvn_stats),
        "serving": make_beam_decoder(model, cfg_serv, tokenizer, cmvn_stats),
        "greedy": None,  # built below (different return contract)
    }
    greedy = make_greedy_decoder(model, config, cmvn_stats)

    # One warmup per (variant, bucket shape), then interleave.
    lat = {k: [] for k in variants}
    hyps = {k: {} for k in variants}
    warmed = set()
    batches = list(loader.epoch(0))
    for b in batches:
        a, al = jnp.asarray(b.audio), jnp.asarray(b.audio_len)
        for name in ("exact", "serving", "greedy"):
            key = (name, b.audio.shape[1])
            def run():
                if name == "greedy":
                    ids, lens = greedy(state.params, a, al)
                    return ids_to_texts(np.asarray(ids), np.asarray(lens),
                                        tokenizer)
                texts, _ = variants[name](state.params, a, al)
                return texts
            if key not in warmed:
                run()
                warmed.add(key)
            t0 = time.perf_counter()
            texts = run()
            lat[name].append(time.perf_counter() - t0)
            hyps[name][b.utt_ids[0]] = texts[0]

    out = {"utts": len(batches)}
    for name, xs in lat.items():
        xs = sorted(xs)
        out[name] = {
            "p50_s": round(xs[len(xs) // 2], 4),
            "mean_s": round(sum(xs) / len(xs), 4),
        }
    out["serving_equals_exact_hyps"] = hyps["serving"] == hyps["exact"]
    out["exact_over_serving_p50"] = round(
        out["exact"]["p50_s"] / out["serving"]["p50_s"], 3)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
