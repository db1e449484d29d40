"""Bootstrap WER/CER CI tool [VERDICT r1 item 5]: point estimates match
eval.metrics exactly; intervals bracket the point and shrink with N."""

import importlib.util
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "wer_ci", os.path.join(REPO, "tools", "wer_ci.py")
)
wer_ci = importlib.util.module_from_spec(spec)
spec.loader.exec_module(wer_ci)

from gluon_e2e_asr.eval.metrics import cer, wer


def _write(path, pairs):
    with open(path, "w") as f:
        for i, (ref, hyp) in enumerate(pairs):
            f.write(json.dumps({"utt_id": f"u{i}", "ref": ref,
                                "hyp": hyp, "score": 0.0}) + "\n")


def test_point_estimates_match_metrics(tmp_path):
    pairs = [("a b c", "a b c"), ("d e", "d x"), ("f g h i", "f g")]
    path = str(tmp_path / "d.jsonl")
    _write(path, pairs)
    c = wer_ci.per_utt_counts(path)
    w, lw, hw, ce, lc, hc = wer_ci.bootstrap_ci(c, iters=2000)
    refs = [r for r, _ in pairs]
    hyps = [h for _, h in pairs]
    assert abs(w - wer(refs, hyps)) < 1e-12
    assert abs(ce - cer(refs, hyps)) < 1e-12
    assert lw <= w <= hw and lc <= ce <= hc


def test_paired_compare_tighter_than_unpaired(tmp_path):
    """Paired diff CI is tighter than the two marginal CIs combined, and
    detects a systematic 1-word improvement."""
    rng = np.random.default_rng(1)
    pairs_a, pairs_b = [], []
    for i in range(96):
        ref = "a b c d e f g h"
        # Decoder A errs on ~2 words, B errs on the same words plus one.
        errs = int(rng.integers(0, 3))
        hyp_words = ref.split()
        for j in range(errs):
            hyp_words[j] = "x"
        pairs_a.append((ref, " ".join(hyp_words)))
        hyp_words_b = list(hyp_words)
        hyp_words_b[-1] = "y"
        pairs_b.append((ref, " ".join(hyp_words_b)))
    pa = str(tmp_path / "a.jsonl")
    pb = str(tmp_path / "b.jsonl")
    _write(pa, pairs_a)
    _write(pb, pairs_b)
    ca = wer_ci.per_utt_counts(pa, keyed=True)
    cb = wer_ci.per_utt_counts(pb, keyed=True)
    keys = sorted(ca)
    ca = np.asarray([ca[k] for k in keys], np.float64)
    cb = np.asarray([cb[k] for k in keys], np.float64)
    d, lo, hi, p_ge = wer_ci.paired_diff_ci(ca, cb, iters=3000)
    assert abs(d - (-1.0 / 8.0)) < 1e-9  # exactly one word in eight
    assert hi < 0  # significant: A strictly better
    assert p_ge < 0.01


def test_interval_shrinks_with_n(tmp_path):
    rng = np.random.default_rng(0)

    def corpus(n):
        pairs = []
        for _ in range(n):
            # ~20% word error rate
            pairs.append(("w x y z v", "w x y z v"
                          if rng.random() > 0.5 else "w x y z q"))
        return pairs

    small = str(tmp_path / "small.jsonl")
    big = str(tmp_path / "big.jsonl")
    _write(small, corpus(16))
    _write(big, corpus(256))
    _, lw_s, hw_s, *_ = wer_ci.bootstrap_ci(
        wer_ci.per_utt_counts(small), iters=3000)
    _, lw_b, hw_b, *_ = wer_ci.bootstrap_ci(
        wer_ci.per_utt_counts(big), iters=3000)
    assert (hw_b - lw_b) < (hw_s - lw_s)
