"""Offline n-best LM rescoring: re-rank each utterance's beam n-best
list with an external LM and report the re-ranked WER.

    python tools/rescore_nbest.py records.jsonl --lm <lm.msgpack> \
        [--weight 0.3] [--output rescored.jsonl]

``records.jsonl`` comes from the decode CLI with ``decode.nbest > 1``
(each record carries ``nbest: [{hyp, score}, ...]``). The re-ranked
score is ``score + weight * log p_lm(hyp, eos)`` — the second standard
use of the reference family's external LM next to in-search shallow
fusion (``decode.lm_weight``) [SURVEY.md §2.1 #17; models/lm.py].
Rescoring composes with fusion: the in-search lists can themselves come
from a fused decode.

Prints one JSON summary line {baseline_wer, rescored_wer, oracle_wer,
num_utts}; --output writes per-utterance re-ranked records.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("records", help="decode JSONL with nbest lists")
    p.add_argument("--lm", required=True, help="train_lm.py checkpoint")
    p.add_argument("--weight", type=float, default=0.3)
    p.add_argument("--lm-length-norm", action="store_true",
                   help="divide each candidate's LM log-prob by its "
                        "token count (+1 for eos). Use when the decode "
                        "ran with decode.length_norm=true, so both "
                        "terms of the re-ranked score are per-token "
                        "quantities; without it a raw LM sum added to "
                        "normalized AM scores over-penalizes long "
                        "hypotheses.")
    p.add_argument("--output", default="")
    args = p.parse_args(argv)

    from gluon_e2e_asr.data.tokenizer import (CharTokenizer,
                                                    tokenizer_from_json)
    from gluon_e2e_asr.eval.metrics import edit_distance, wer
    from gluon_e2e_asr.models.lm import lm_logprob_batch, load_lm

    model, params, meta = load_lm(args.lm)
    tokenizer = (tokenizer_from_json(meta["vocab"])
                 if meta.get("vocab") else CharTokenizer())

    records = []
    with open(args.records) as f:
        for line in f:
            rec = json.loads(line)
            if not rec.get("nbest"):
                raise SystemExit(
                    "records carry no nbest lists — decode with "
                    "--set decode.nbest=N (N > 1)")
            records.append(rec)

    # One batched LM pass over every (utterance, candidate) pair: padded
    # rows share a handful of compiled shapes instead of one per length.
    flat = [tokenizer.encode(c["hyp"])
            for rec in records for c in rec["nbest"]]
    lps = lm_logprob_batch(model, params, flat, tokenizer.eos_id,
                           tokenizer.sos_id)

    refs, base_hyps, new_hyps, oracle_hyps = [], [], [], []
    out_records = []
    pos = 0
    for rec in records:
        nbest = rec["nbest"]
        refs.append(rec["ref"])
        base_hyps.append(nbest[0]["hyp"])
        rescored = []
        for cand in nbest:
            lp = float(lps[pos])
            pos += 1
            lm_term = lp
            if args.lm_length_norm:
                lm_term = lp / (len(tokenizer.encode(cand["hyp"])) + 1)
            rescored.append(
                {"hyp": cand["hyp"],
                 "score": cand["score"] + args.weight * lm_term,
                 "am_score": cand["score"],
                 "lm_logprob": round(lp, 4)})
        rescored.sort(key=lambda c: -c["score"])
        new_hyps.append(rescored[0]["hyp"])
        rw = rec["ref"].split()
        oracle_hyps.append(min(
            (c["hyp"] for c in rescored),
            key=lambda t: edit_distance(rw, t.split())))
        out_records.append(dict(rec, hyp=rescored[0]["hyp"],
                                nbest=rescored))

    if args.output:
        with open(args.output, "w") as f:
            for rec in out_records:
                f.write(json.dumps(rec) + "\n")
    print(json.dumps({
        "event": "rescore_done",
        "num_utts": len(refs),
        "lm_weight": args.weight,
        "baseline_wer": round(wer(refs, base_hyps), 4),
        "rescored_wer": round(wer(refs, new_hyps), 4),
        "oracle_wer": round(wer(refs, oracle_hyps), 4),
        "output": args.output,
    }))


if __name__ == "__main__":
    main()
