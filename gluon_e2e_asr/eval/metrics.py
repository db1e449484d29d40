"""WER/CER scoring via Levenshtein edit distance.

Reference-side realization: Python edit distance or an sclite shellout
[SURVEY.md §2.1 #19, INFERRED-med]. New-repo realization: a native C++
edit-distance core (``native/edit_distance.cpp``, ctypes) for corpus
scoring throughput, with a pure-Python fallback; both are parity-tested
[SURVEY.md §4 "Unit: tokenizer/WER"].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def _edit_distance_py(ref: Sequence, hyp: Sequence) -> int:
    """Classic O(|ref|*|hyp|) Levenshtein distance, two-row DP."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    cur = [0] * (m + 1)
    for i in range(1, n + 1):
        cur[0] = i
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev, cur = cur, prev
    return prev[m]


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance between two sequences (tokens or chars)."""
    try:
        from gluon_e2e_asr.utils.native import edit_distance_native

        if all(isinstance(x, str) for x in ref) and all(
            isinstance(x, str) for x in hyp
        ):
            return edit_distance_native(list(ref), list(hyp))
    except Exception:
        pass
    return _edit_distance_py(list(ref), list(hyp))


def wer(refs: List[str], hyps: List[str]) -> float:
    """Word error rate over a corpus: sum(edits) / sum(ref words)."""
    assert len(refs) == len(hyps)
    edits, total = 0, 0
    for r, h in zip(refs, hyps):
        rw, hw = r.split(), h.split()
        edits += edit_distance(rw, hw)
        total += len(rw)
    return edits / max(total, 1)


def cer(refs: List[str], hyps: List[str]) -> float:
    """Character error rate over a corpus (spaces included)."""
    assert len(refs) == len(hyps)
    edits, total = 0, 0
    for r, h in zip(refs, hyps):
        edits += edit_distance(list(r), list(h))
        total += len(r)
    return edits / max(total, 1)


def align_counts(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """Minimum-edit alignment counts ``(sub, del, ins, hits)``.

    The sclite-style decomposition the reference family's error reports
    print [SURVEY.md §2.1 #19]: ``sub + del + ins == edit_distance`` and
    ``sub + del + hits == len(ref)``. Full DP with backtrack — O(|ref|
    * |hyp|) memory, fine at utterance scale. Ties prefer substitution
    over deletion over insertion (sclite's convention; any choice gives
    the same total distance)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = distance between ref[:i] and hyp[:j]
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        ri = ref[i - 1]
        row, prev = dp[i], dp[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            row[j] = min(prev[j] + 1, row[j - 1] + 1, prev[j - 1] + cost)
    sub = dele = ins = hits = 0
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            diag_cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            if dp[i][j] == dp[i - 1][j - 1] + diag_cost:
                if diag_cost:
                    sub += 1
                else:
                    hits += 1
                i -= 1
                j -= 1
                continue
        if i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            dele += 1
            i -= 1
            continue
        ins += 1
        j -= 1
    return sub, dele, ins, hits


def error_report(refs: List[str], hyps: List[str], unit: str = "word"):
    """Corpus-level S/D/I error decomposition (the reference family's
    detailed ``result.txt``-style report). ``unit`` is "word" (split on
    whitespace) or "char". Returns a dict with absolute counts and rates
    over the reference length; ``rate == sub_rate + del_rate + ins_rate``
    equals :func:`wer`/:func:`cer` for the same inputs."""
    assert len(refs) == len(hyps)
    assert unit in ("word", "char")
    split = (lambda s: s.split()) if unit == "word" else list
    sub = dele = ins = hits = total = 0
    for r, h in zip(refs, hyps):
        s, d, i, c = align_counts(split(r), split(h))
        sub += s
        dele += d
        ins += i
        hits += c
        total += s + d + c
    denom = max(total, 1)
    return {
        "unit": unit,
        "ref_tokens": total,
        "hits": hits,
        "sub": sub,
        "del": dele,
        "ins": ins,
        "rate": (sub + dele + ins) / denom,
        "sub_rate": sub / denom,
        "del_rate": dele / denom,
        "ins_rate": ins / denom,
    }
