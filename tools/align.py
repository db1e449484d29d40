"""CTC forced alignment CLI: token-level timestamps for reference
transcripts (the alignment surface of the CTC lattice —
ops/ctc.py::ctc_viterbi_align; [SURVEY.md §2.1 #9]).

    python tools/align.py --config <yaml> --ckpt <ckpt> \
        [--output align.jsonl] [--num N] [--set KEY=VAL ...]

Aligns each dev-split utterance's REFERENCE text to the audio with the
checkpoint's CTC head (Viterbi over the blank-interleaved lattice, all
on device) and emits one JSONL record per utterance:

    {utt_id, text, score, tokens: [{token, start_s, end_s}, ...]}

Times are in seconds: encoder frame f spans
``f*R*hop/sr .. (f+1)*R*hop/sr`` where R = the encoder's total time
reduction (config.encoder_time_reduction: prod(enc_subsample), times 4
for the vggblstm conv front).
Requires a CTC-trained head (loss.mtl_alpha > 0 during training).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import Config, apply_overrides, load_config
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer, tokenizer_from_json
from gluon_e2e_asr.frontend.features import frontend_apply
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.ops.ctc import ctc_viterbi_align, spans_from_states
from gluon_e2e_asr.training.checkpoint import restore_checkpoint
from gluon_e2e_asr.training.train_step import (
    create_template_state,
    make_optimizer,
)
from gluon_e2e_asr.training.trainer import build_datasets
from gluon_e2e_asr.utils.logging import JsonlLogger


def write_ctm(fh, utt_id, spans):
    """sclite CTM lines: ``utt channel start dur token`` (channel 1;
    whitespace tokens rendered as <sp>; unaligned tokens skipped)."""
    for s in spans:
        if s["start_s"] is None:
            continue
        tok = s["token"] if s["token"].strip() else "<sp>"
        fh.write(f"{utt_id} 1 {s['start_s']:.4f} "
                 f"{s['end_s'] - s['start_s']:.4f} {tok}\n")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="CTC forced alignment of reference transcripts")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--output", type=str, default="align.jsonl")
    p.add_argument("--num", type=int, default=0,
                   help="align at most N utterances (0 = all)")
    p.add_argument("--ctm", type=str, default="",
                   help="also write sclite CTM lines "
                        "(utt_id channel start_s dur_s token)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = p.parse_args(argv)

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if config.loss.mtl_alpha <= 0:
        print("warning: loss.mtl_alpha == 0 — the checkpoint has no "
              "trained CTC head; alignments will be meaningless",
              file=sys.stderr)

    tokenizer = CharTokenizer()
    meta_path = args.ckpt + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta0 = json.load(f)
        if meta0.get("vocab"):
            tokenizer = tokenizer_from_json(meta0["vocab"])

    _, dev_utts = build_datasets(config)
    if args.num > 0:
        dev_utts = dev_utts[: args.num]
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch,
    )
    sampler = BucketSampler(dev_utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    if sampler.skipped:
        print(f"warning: {len(sampler.skipped)} utterance(s) exceed every "
              "bucket bound (duration or label budget) and are NOT "
              "aligned — raise data.bucket_bounds_sec / "
              "data.max_label_len", file=sys.stderr)
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
    state, cmvn_stats, _ = restore_checkpoint(
        args.ckpt, template, params_only=True)

    @jax.jit
    def align_fn(params, audio, audio_len, labels, label_len):
        feats, feat_len = frontend_apply(
            config.frontend, audio, audio_len, train=False,
            cmvn_stats=cmvn_stats)
        _, enc_len, ctc_logits = model.apply(
            {"params": params}, feats, feat_len, method=model.encode)
        logp = jax.nn.log_softmax(ctc_logits, axis=-1)
        return ctc_viterbi_align(logp, enc_len, labels, label_len)

    from gluon_e2e_asr.config import encoder_time_reduction

    R = encoder_time_reduction(config.model)
    sec_per_frame = R * config.frontend.hop_length / config.data.sample_rate

    by_id = {u.utt_id: u for u in dev_utts}
    logger = JsonlLogger(args.output, also_stdout=False, mode="w")
    ctm = open(args.ctm, "w") if args.ctm else None
    n = 0
    n_trunc = 0
    for b in loader.epoch(0):
        states, score = align_fn(
            state.params, jnp.asarray(b.audio), jnp.asarray(b.audio_len),
            jnp.asarray(b.labels), jnp.asarray(b.label_len))
        states, score = np.asarray(states), np.asarray(score)
        for row, utt_id in enumerate(b.utt_ids):
            text = by_id[utt_id].text
            toks = [tokenizer.decode([int(i)])
                    for i in b.labels[row][: b.label_len[row]]]
            spans = spans_from_states(states[row], toks, sec_per_frame)
            rec = {
                "utt_id": utt_id,
                "text": text,
                "score": float(score[row]),
                "tokens": spans,
            }
            # The loader clips labels to the bucket's label budget —
            # a transcript longer than that would otherwise lose its
            # tail tokens SILENTLY.
            full_len = len(tokenizer.encode(text))
            if int(b.label_len[row]) < full_len:
                rec["truncated"] = True
                n_trunc += 1
            logger.log(rec)
            if ctm is not None:
                write_ctm(ctm, utt_id, spans)
            n += 1
    logger.close()
    if ctm is not None:
        ctm.close()
    summary = {"event": "align_done", "num_utts": n,
               "skipped": len(sampler.skipped),
               "sec_per_frame": sec_per_frame,
               "output": args.output}
    if n_trunc:
        summary["truncated"] = n_trunc
        print(f"warning: {n_trunc} transcript(s) exceeded the bucket "
              "label budget; their tail tokens are missing from the "
              "alignment (records carry truncated: true)",
              file=sys.stderr)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
