"""One-shot extractor: build the checked-in English sentence pool for the
synthetic fixture (``gluon_e2e_asr/data/english_pool.txt``).

VERDICT.md round-2 item 1: the synthetic corpus previously used *random*
token sequences, so every language-dependent recipe experiment (LM
shallow fusion, n-best rescoring, BPE-vs-char, decode-knob tuning) came
back null by construction. This script harvests real English prose from
the Python distribution's documentation corpus (``pydoc_data/topics.py``,
PSF-licensed, present on this image at /usr/lib/python3.11) and
normalizes it to the fixture's character alphabet, giving the synthetic
transcripts genuine English word structure — the one axis those recipes
exist to exploit.

The output file is deterministic given the same source text: sentences
are normalized, filtered, de-duplicated, and sorted. It is checked into
the repo so runtime never depends on the source path. Re-run only to
regenerate the pool from a different source.

Usage::

    python tools/extract_english_pool.py \
        --source /usr/lib/python3.11/pydoc_data/topics.py \
        --out gluon_e2e_asr/data/english_pool.txt
"""

from __future__ import annotations

import argparse
import re
import runpy

ALPHABET = set(" 'abcdefghijklmnopqrstuvwxyz")


def normalize(sentence: str) -> str:
    """Lowercase and project onto the fixture alphabet (space-collapsed)."""
    s = sentence.lower()
    out = []
    for ch in s:
        out.append(ch if ch in ALPHABET else " ")
    return re.sub(r"\s+", " ", "".join(out)).strip()


def harvest(text: str, min_words: int, max_words: int,
            max_loss_frac: float) -> list:
    """Split prose into sentences, normalize, filter junk."""
    # Collapse RST markup noise before sentence splitting.
    text = re.sub(r"``[^`]*``", " ", text)          # inline code literals
    text = re.sub(r"\*+[^*\n]*\*+", " ", text)      # emphasis / refs
    text = re.sub(r'"[^"\n]*"', " ", text)          # quoted tokens
    text = re.sub(r"\s+", " ", text)
    kept = []
    for raw in re.split(r"(?<=[.!?;:]) ", text):
        raw = raw.strip()
        if not raw or len(raw) < 24:
            continue
        norm = normalize(raw)
        if not norm:
            continue
        # Reject fragments where normalization destroyed a lot of content
        # (code snippets, grammar productions, tables).
        alpha_raw = sum(c.isalpha() or c == " " for c in raw)
        if alpha_raw / max(len(raw), 1) < 1.0 - max_loss_frac:
            continue
        words = norm.split()
        if not (min_words <= len(words) <= max_words):
            continue
        if any(len(w) > 16 for w in words):
            continue
        # Require mostly real-looking words (length >= 2, has a vowel).
        good = sum(1 for w in words
                   if len(w) >= 2 and any(v in w for v in "aeiouy"))
        if good / len(words) < 0.85:
            continue
        kept.append(norm)
    return sorted(set(kept))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source",
                   default="/usr/lib/python3.11/pydoc_data/topics.py")
    p.add_argument("--out",
                   default="gluon_e2e_asr/data/english_pool.txt")
    p.add_argument("--min-words", type=int, default=5)
    p.add_argument("--max-words", type=int, default=28)
    p.add_argument("--max-loss-frac", type=float, default=0.12)
    p.add_argument("--max-sentences", type=int, default=6000)
    args = p.parse_args(argv)

    mod = runpy.run_path(args.source)
    topics = mod["topics"]
    text = "\n".join(topics[k] for k in sorted(topics))
    pool = harvest(text, args.min_words, args.max_words, args.max_loss_frac)
    pool = pool[: args.max_sentences]
    with open(args.out, "w") as f:
        f.write("# English sentence pool for the synthetic ASR fixture.\n")
        f.write("# Source: Python documentation prose (pydoc_data/topics.py,\n")
        f.write("# PSF license), normalized to the char alphabet by\n")
        f.write("# tools/extract_english_pool.py. Deterministic; checked in.\n")
        f.write("\n".join(pool) + "\n")
    n_words = sum(len(s.split()) for s in pool)
    print(f"wrote {len(pool)} sentences ({n_words} words) to {args.out}")


if __name__ == "__main__":
    main()
