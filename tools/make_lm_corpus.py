"""Build the shallow-fusion LM text corpus for an english-fixture config:
the full checked-in English pool MINUS every sentence containing any dev
transcript as a substring.

The reference family trains its char LM on much more text than the
paired audio has (lm.extra_text exists for exactly this), but on this
fixture the dev transcripts are word windows drawn from the same pool —
training the LM on unfiltered pool text would leak dev word sequences.
This filter keeps the setting honest: the LM sees the language, never
the dev windows. [VERDICT.md round-2 item 1]

Usage::

    python tools/make_lm_corpus.py --config configs/english_m5.yaml \
        --out /tmp/lm_corpus.txt
    python -m gluon_e2e_asr.train_lm --config configs/english_m5.yaml \
        --workdir runs/english_lm --set lm.extra_text=/tmp/lm_corpus.txt
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gluon_e2e_asr.config import apply_overrides, load_config  # noqa: E402
from gluon_e2e_asr.data.manifest import english_pool  # noqa: E402
from gluon_e2e_asr.training.trainer import build_datasets  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = p.parse_args(argv)

    config = load_config(args.config)
    apply_overrides(config, args.set)
    _, dev_utts = build_datasets(config)
    dev_texts = [u.text for u in dev_utts]

    if config.data.synth_split == "sentence":
        # Round-4 disjoint fixture: the train-side pool is leakage-free
        # by construction (dev windows come from dev-side sentences and
        # are rejected if present in train-side text). The window filter
        # below still runs as a belt-and-braces assertion — it must drop
        # nothing.
        from gluon_e2e_asr.data.manifest import english_pool_split
        pool = english_pool_split("train")
    else:
        pool = english_pool()
    kept = [ln for ln in pool
            if not any(t in ln for t in dev_texts)]
    if config.data.synth_split == "sentence" and len(kept) != len(pool):
        raise AssertionError(
            f"sentence split promised zero dev-window leakage but the "
            f"filter dropped {len(pool) - len(kept)} train-side sentences")
    with open(args.out, "w") as f:
        f.write("\n".join(kept) + "\n")
    print(f"LM corpus: kept {len(kept)}/{len(pool)} pool sentences "
          f"(dropped {len(pool) - len(kept)} containing a dev window) "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
