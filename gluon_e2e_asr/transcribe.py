"""One-off transcription CLI — decode arbitrary audio files with a
trained checkpoint, no manifest or reference transcripts needed:

    python -m gluon_e2e_asr.transcribe --ckpt best.msgpack \
        [--config recipe.yaml] [--method greedy|beam|ctc_beam] \
        [--output out.jsonl] [--set KEY=VAL ...] a.wav b.flac c.npy

Prints one ``utt_id\\thypothesis`` line per file (file order) and
optionally writes decode-style JSONL records. The recognize()
convenience surface of the reference's public decode API
[BASELINE.json:L5; SURVEY.md §3.2] for audio that has no manifest yet:
files are probed for duration, bucketed like the eval loader (a
catch-all bucket is appended so no input is ever skipped), and run
through the same jitted decoders as ``decode.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import Config, apply_overrides, load_config
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.manifest import Utterance, _probe_duration
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer, tokenizer_from_json
from gluon_e2e_asr.decoding.greedy import ids_to_texts, make_greedy_decoder
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.training.checkpoint import restore_checkpoint
from gluon_e2e_asr.training.train_step import (
    create_template_state,
    make_optimizer,
)
from gluon_e2e_asr.utils.logging import JsonlLogger


def build_file_utts(paths, sample_rate):
    """Probe each audio file and wrap it as a manifest Utterance."""
    utts = []
    for i, p in enumerate(paths):
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        dur = _probe_duration(p, sample_rate)
        if dur <= 0:
            raise ValueError(
                f"{p}: could not determine duration (supported: 16 kHz "
                ".wav/.flac, .npy float32)")
        utts.append(Utterance(
            utt_id=f"{i:04d}_{os.path.basename(p)}",
            text="", duration=round(dur, 4), audio_path=p))
    return utts


def specs_covering(config, max_dur):
    """Eval bucket specs, extended with a catch-all bucket so files
    longer than the configured bounds are transcribed, not dropped.

    The catch-all is appended AFTER the configured specs are built:
    with ``data.dynamic_batch`` the per-bucket batch size scales as
    largest_bound/bound, so folding one long input into the bound list
    would inflate every short bucket's batch size (and its compiled
    shape) proportionally to that file. The catch-all itself gets a
    dynamic size relative to the configured largest bound, floored at 1.
    """
    from gluon_e2e_asr.data.sampler import BucketSpec

    bounds = list(config.data.bucket_bounds_sec)
    specs = make_bucket_specs(
        bounds, config.data.sample_rate, config.data.batch_size,
        config.data.max_label_len, config.frontend.hop_length,
        config.data.dynamic_batch,
    )
    if max_dur > bounds[-1]:
        b = float(np.ceil(max_dur * 2) / 2)  # round up to 0.5 s
        hop = config.frontend.hop_length
        n = int(round(b * config.data.sample_rate))
        n = ((n + hop - 1) // hop) * hop
        bs = config.data.batch_size
        if config.data.dynamic_batch:
            bs = max(1, int(bs * bounds[-1] / b))
        specs.append(BucketSpec(
            max_samples=n, max_labels=config.data.max_label_len,
            batch_size=bs))
    return specs


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Transcribe audio files with a trained checkpoint")
    p.add_argument("audio", nargs="+", help="16 kHz .wav/.flac/.npy files")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--config", type=str, default="",
                   help="the training recipe yaml (model/frontend fields "
                        "must match the checkpoint)")
    p.add_argument("--method", type=str, default="",
                   choices=["", "greedy", "beam", "ctc_beam"],
                   help="override decode.method")
    p.add_argument("--output", type=str, default="",
                   help="also write decode-style JSONL records here")
    p.add_argument("--timestamps", action="store_true",
                   help="add per-token {token, start_s, end_s} spans to "
                        "the --output JSONL records by CTC-force-aligning "
                        "each hypothesis (needs a CTC-trained head, i.e. "
                        "loss.mtl_alpha > 0 at training time)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = p.parse_args(argv)
    if args.timestamps and not args.output:
        p.error("--timestamps writes token spans into the JSONL records; "
                "pass --output as well")

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if args.method:
        config.decode.method = args.method
    # Interactive-serving defaults at B=1 [VERDICT.md round-2 item 5].
    from gluon_e2e_asr.decoding.serving import apply_b1_serving_defaults

    apply_b1_serving_defaults(config, args.set)

    tokenizer = CharTokenizer()
    meta_path = args.ckpt + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta0 = json.load(f)
        if meta0.get("vocab"):
            tokenizer = tokenizer_from_json(meta0["vocab"])

    utts = build_file_utts(args.audio, config.data.sample_rate)
    specs = specs_covering(config, max(u.duration for u in utts))
    sampler = BucketSampler(utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    if sampler.skipped:
        # Only label overflow can skip now (catch-all duration bucket);
        # with empty texts that cannot happen — guard anyway.
        bad = [utts[i].audio_path for i in sampler.skipped]
        raise ValueError(f"unbucketable inputs: {bad}")
    loader = DataLoader(utts, sampler, tokenizer, config.data.sample_rate,
                        transfer_dtype=config.data.transfer_dtype)

    model = build_model(config, tokenizer.vocab_size, tokenizer.sos_id,
                        tokenizer.eos_id)
    first = next(iter(loader.epoch(0)))
    template = create_template_state(
        config, model, make_optimizer(config),
        {"audio": first.audio, "audio_len": first.audio_len,
         "labels": first.labels, "label_len": first.label_len},
    )
    state, cmvn_stats, _ = restore_checkpoint(args.ckpt, template, params_only=True)

    is_beam = config.decode.method in ("beam", "ctc_beam")
    if is_beam:
        from gluon_e2e_asr.decoding.beam import make_beam_decoder

        decoder = make_beam_decoder(model, config, tokenizer, cmvn_stats)
    else:
        decoder = make_greedy_decoder(model, config, cmvn_stats)

    align_fn = sec_per_frame = None
    if args.timestamps:
        from gluon_e2e_asr.frontend.features import frontend_apply
        from gluon_e2e_asr.ops.ctc import (
            ctc_viterbi_align, spans_from_states,
        )

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

        sec_per_frame = (encoder_time_reduction(config.model)
                         * config.frontend.hop_length
                         / config.data.sample_rate)

    logger = JsonlLogger(args.output, also_stdout=False, mode="w") \
        if args.output else None
    results = {}
    warmed = set()
    for b in loader.epoch(0):
        if b.bucket not in warmed:
            # One untimed pass per bucket shape so the emitted latency_s
            # measures device time, not XLA compilation (same discipline
            # as decode.py).
            out = decoder(state.params, jnp.asarray(b.audio),
                          jnp.asarray(b.audio_len))
            for leaf in jax.tree_util.tree_leaves(out):
                if hasattr(leaf, "block_until_ready"):
                    np.asarray(leaf)
            warmed.add(b.bucket)
        t0 = time.perf_counter()
        if is_beam:
            texts, scores = decoder(state.params, jnp.asarray(b.audio),
                                    jnp.asarray(b.audio_len))
        else:
            ids, lens = decoder(state.params, jnp.asarray(b.audio),
                                jnp.asarray(b.audio_len))
            jax.block_until_ready(ids)
            texts = ids_to_texts(np.asarray(ids), np.asarray(lens), tokenizer)
            scores = [0.0] * len(texts)
        per_utt = (time.perf_counter() - t0) / max(b.num_real, 1)
        spans = [None] * len(texts)
        if align_fn is not None:
            # Force-align each HYPOTHESIS back to the audio: encode the
            # texts into the batch's static label shape (clipped to the
            # bucket's label budget) and Viterbi over the CTC lattice.
            L = b.labels.shape[1]
            labels = np.zeros_like(b.labels)
            label_len = np.zeros_like(b.label_len)
            for row, t in enumerate(texts):
                ids_row = tokenizer.encode(t)[:L]
                labels[row, :len(ids_row)] = ids_row
                label_len[row] = len(ids_row)
            states, _ = align_fn(
                state.params, jnp.asarray(b.audio),
                jnp.asarray(b.audio_len), jnp.asarray(labels),
                jnp.asarray(label_len))
            states = np.asarray(states)
            for row, t in enumerate(texts):
                toks = [tokenizer.decode([int(i)])
                        for i in labels[row][: label_len[row]]]
                spans[row] = spans_from_states(states[row], toks,
                                               sec_per_frame)
        for row, utt_id in enumerate(b.utt_ids):
            results[utt_id] = texts[row]
            if logger is not None:
                rec = {
                    "utt_id": utt_id,
                    "hyp": texts[row],
                    "score": float(scores[row]),
                    "latency_s": round(per_utt, 5),
                    "latency_basis": "batch-amortized-per-utt",
                }
                if spans[row] is not None:
                    rec["tokens"] = spans[row]
                logger.log(rec)
    # File order, regardless of buckets (NOT a lexicographic sort of the
    # ids: the zero-padded index prefix widens past 9999 inputs and
    # would interleave).
    for u in utts:
        if u.utt_id in results:
            print(f"{u.utt_id}\t{results[u.utt_id]}")
    if logger is not None:
        logger.close()
    return results


if __name__ == "__main__":
    main()
