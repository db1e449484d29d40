"""Decode CLI: ``python -m gluon_e2e_asr.decode --config <yaml> --ckpt <path>``.

The public decode/recognize entry point [BASELINE.json:L5; SURVEY.md
§3.2]: restore params + vocab, run bucketed eval batches through the
jitted decoder (greedy or batched beam with CTC prefix scoring), emit
per-utterance JSONL {utt_id, hyp, ref, score, latency_s} for the
fidelity harness [SURVEY.md §2.1 #22], then report WER/CER and p50
latency [BASELINE.json:L2].
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import Config, apply_overrides, load_config
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer, tokenizer_from_json
from gluon_e2e_asr.decoding.beam import NEG_INF as BEAM_NEG_INF
from gluon_e2e_asr.decoding.greedy import ids_to_texts, make_greedy_decoder
from gluon_e2e_asr.eval.metrics import (
    cer, edit_distance, error_report, wer,
)
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.training.checkpoint import restore_checkpoint
from gluon_e2e_asr.training.train_step import (
    create_template_state,
    make_optimizer,
)
from gluon_e2e_asr.training.trainer import build_datasets
from gluon_e2e_asr.utils.logging import JsonlLogger, percentile


def filled_nbest(nbest_row):
    """Drop unfilled n-best slots. The beam pads missing hypotheses with
    its NEG_INF sentinel (-1e30) — which IS np.isfinite, so a finiteness
    check would let phantom empty hypotheses pollute the records and the
    oracle-WER candidate set."""
    return [(t, s) for t, s in nbest_row if s > BEAM_NEG_INF / 2]


def main(argv=None):
    p = argparse.ArgumentParser(description="E2E ASR decoding")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--output", type=str, default="")
    p.add_argument("--method", type=str, default="",
                   choices=["", "greedy", "beam", "ctc_beam"],
                   help="override decode.method")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="dotted config override, e.g. decode.beam_size=20 "
                        "(repeatable)")
    p.add_argument("--min-dur", type=float, default=0.0,
                   help="decode only dev utterances at least this many "
                        "seconds long (targeted measurement, e.g. the "
                        "end-detect long-utterance A/B)")
    p.add_argument("--max-utts", type=int, default=0,
                   help="cap the dev set at the first N utterances after "
                        "filtering (0 = all)")
    args = p.parse_args(argv)

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if args.method:
        config.decode.method = args.method
    out_path = args.output or config.decode.output_path

    # The tokenizer decides the model head width, so it must be known
    # before the restore template is built. Peek the checkpoint's meta
    # sidecar: every trainer checkpoint serializes the exact vocab it
    # trained with (char or BPE); a bare payload with no sidecar falls
    # back to the default char vocab (the historical behavior).
    tokenizer = CharTokenizer()
    meta_path = args.ckpt + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            _meta0 = json.load(f)
        if _meta0.get("vocab"):
            tokenizer = tokenizer_from_json(_meta0["vocab"])
    _, dev_utts = build_datasets(config)
    if args.min_dur > 0:
        dev_utts = [u for u in dev_utts if u.duration >= args.min_dur]
    if args.max_utts > 0:
        dev_utts = dev_utts[: args.max_utts]
    if not dev_utts:
        raise SystemExit(
            f"--min-dur {args.min_dur} left no dev utterances to decode")
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch,
    )
    sampler = BucketSampler(dev_utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    loader = DataLoader(dev_utts, sampler, tokenizer, config.data.sample_rate,
                        transfer_dtype=config.data.transfer_dtype)

    # Interactive-serving defaults at B=1 [VERDICT.md round-2 item 5]:
    # partial CTC scoring + end-detect (decoding/serving.py; explicit
    # --set values win; batched decode is unchanged).
    from gluon_e2e_asr.decoding.serving import apply_b1_serving_defaults

    apply_b1_serving_defaults(config, args.set)

    model = build_model(config, tokenizer.vocab_size, tokenizer.sos_id,
                        tokenizer.eos_id)
    tx = make_optimizer(config)
    # Restore template: abstract shapes only — no init compile.
    first = next(iter(loader.epoch(0)))
    template = create_template_state(
        config, model,
        tx,
        {"audio": first.audio, "audio_len": first.audio_len,
         "labels": first.labels, "label_len": first.label_len},
    )
    state, cmvn_stats, meta = restore_checkpoint(args.ckpt, template, params_only=True)

    mesh = None
    if config.decode.dp:
        from gluon_e2e_asr.parallel.mesh import make_mesh

        mesh = make_mesh()
        ndev = mesh.devices.size
        # Every bucket's batch size must shard evenly: with
        # data.dynamic_batch the per-bucket sizes differ from
        # data.batch_size (sampler.make_bucket_specs scales them).
        bad_bs = sorted({s.batch_size for s in specs if s.batch_size % ndev})
        if bad_bs:
            raise ValueError(
                f"decode.dp needs every bucket batch size divisible by the "
                f"device count ({ndev}); got {bad_bs}")
    is_beam = config.decode.method in ("beam", "ctc_beam")
    if is_beam:
        from gluon_e2e_asr.decoding.beam import make_beam_decoder

        decoder = make_beam_decoder(model, config, tokenizer, cmvn_stats,
                                    mesh=mesh)
    else:
        decoder = make_greedy_decoder(model, config, cmvn_stats, mesh=mesh)

    # "w": each decode run owns its output file — stale records from a
    # previous run would silently pollute the fidelity harness goldens.
    logger = JsonlLogger(out_path, also_stdout=False, mode="w")
    refs, hyps, latencies = [], [], []
    beam_steps = []  # executed while_loop steps per batch (beam methods)
    oracle_hyps = []  # per-utt min-word-error hypothesis within the nbest
    by_id = {u.utt_id: u for u in dev_utts}
    warmed = set()
    for b in loader.epoch(0):
        if b.bucket not in warmed:
            # One untimed pass per bucket shape so p50 latency measures
            # device time, not XLA compilation [BASELINE.json:L2;
            # SURVEY.md §7 hard part 6 "honest benchmarking"].
            out = decoder(state.params, jnp.asarray(b.audio),
                          jnp.asarray(b.audio_len))
            for leaf in jax.tree_util.tree_leaves(out):
                if hasattr(leaf, "block_until_ready"):
                    np.asarray(leaf)  # full path incl. device->host fetch
            warmed.add(b.bucket)
        t0 = time.perf_counter()
        nbest_lists = None
        if is_beam and config.decode.nbest > 1:
            nbest_lists = decoder.nbest(state.params, jnp.asarray(b.audio),
                                        jnp.asarray(b.audio_len))
            texts = [nb[0][0] for nb in nbest_lists]
            scores = [nb[0][1] for nb in nbest_lists]
        elif is_beam:
            texts, scores = decoder(state.params, jnp.asarray(b.audio),
                                    jnp.asarray(b.audio_len))
        else:
            ids, lens = decoder(state.params, jnp.asarray(b.audio),
                                jnp.asarray(b.audio_len))
            jax.block_until_ready(ids)
            texts = ids_to_texts(np.asarray(ids), np.asarray(lens), tokenizer)
            scores = [0.0] * len(texts)
        dt = time.perf_counter() - t0
        per_utt = dt / max(b.num_real, 1)
        if is_beam and getattr(decoder, "last_steps", None) is not None:
            beam_steps.append(int(decoder.last_steps))
        for row, utt_id in enumerate(b.utt_ids):
            ref = by_id[utt_id].text
            refs.append(ref)
            hyps.append(texts[row])
            latencies.append(per_utt)
            rec = {
                "utt_id": utt_id,
                "hyp": texts[row],
                "ref": ref,
                "score": float(scores[row]),
                "latency_s": round(per_utt, 5),
            }
            if nbest_lists is not None:
                filled = filled_nbest(nbest_lists[row])
                cands = [t for t, _ in filled]
                rec["nbest"] = [
                    {"hyp": t, "score": round(s, 4)} for t, s in filled
                ]
                rw = ref.split()
                oracle_hyps.append(min(
                    cands or [""],
                    key=lambda t: edit_distance(rw, t.split())))
            logger.log(rec)
    result = {
        "event": "decode_done",
        "method": config.decode.method,
        "num_utts": len(refs),
        "wer": round(wer(refs, hyps), 4),
        "cer": round(cer(refs, hyps), 4),
        # Batch wall time divided by real utterances in the batch — an
        # amortized per-utterance number, NOT a single-utterance latency
        # [VERDICT r1 weak 7].
        "latency_basis": "batch-amortized-per-utt",
        "p50_latency_s": round(percentile(latencies, 50), 5),
        "output": out_path,
    }
    if beam_steps:
        # Device-side search cost, independent of host wall time:
        # executed while_loop steps (max over the batch) per batch call.
        # This is what decode.end_detect actually saves.
        result["beam_steps_total"] = int(sum(beam_steps))
        result["beam_steps_max"] = int(max(beam_steps))
    # sclite-style S/D/I decomposition (sums to the wer above): the
    # reference family's detailed error report [SURVEY.md §2.1 #19].
    rep = error_report(refs, hyps, unit="word")
    result["errors"] = {
        k: (round(v, 4) if isinstance(v, float) else v)
        for k, v in rep.items() if k != "unit"
    }
    if oracle_hyps:
        # Best achievable WER picking per-utterance from the n-best list
        # (the list's headroom diagnostic; always <= the 1-best wer).
        result["oracle_wer"] = round(wer(refs, oracle_hyps), 4)
    print(json.dumps(result))
    logger.close()
    return result


if __name__ == "__main__":
    main()
