"""Propose duration-bucket bounds for a manifest, minimizing padding
waste under a bucket-count budget [SURVEY.md §7 hard part 4: too many
bucket shapes -> compile-time blowup; too few -> padding waste].

Dynamic program over the sorted duration histogram: choose K bound
indices so that sum_i (bound(i) - dur_i) is minimal when every
utterance pads up to its bucket's bound (the classic optimal 1-D
histogram segmentation; O(N^2 K) on the deduplicated durations, N is
small after binning to the frontend hop).

Usage:
  python tools/tune_buckets.py --manifest path.jsonl --buckets 4
  python tools/tune_buckets.py --synthetic 512 --buckets 3   # demo

Prints the proposed ``bucket_bounds_sec`` yaml line plus a waste report
comparing against the current config default.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")


def optimal_bounds(durs: np.ndarray, k: int, hop_sec: float = 0.01):
    """K bucket upper bounds minimizing total padded-seconds waste."""
    # Bin durations to the hop grid: candidate bounds are the distinct
    # binned values (a bound strictly between two durations is never
    # better than the lower duration itself).
    q = np.unique(np.ceil(durs / hop_sec).astype(np.int64))  # grid units
    counts = np.zeros(len(q), np.int64)
    sums = np.zeros(len(q), np.float64)
    binned = np.ceil(durs / hop_sec).astype(np.int64)
    for i, v in enumerate(q):
        m = binned == v
        counts[i] = m.sum()
        sums[i] = (binned[m]).sum()
    n = len(q)
    k = min(k, n)
    csum_cnt = np.concatenate([[0], np.cumsum(counts)])
    csum_dur = np.concatenate([[0], np.cumsum(sums)])

    def seg_waste(lo: int, hi: int) -> float:
        # utterances lo..hi (inclusive) padded to q[hi]
        cnt = csum_cnt[hi + 1] - csum_cnt[lo]
        tot = csum_dur[hi + 1] - csum_dur[lo]
        return float(q[hi]) * cnt - tot

    INF = float("inf")
    dp = np.full((k + 1, n), INF)
    arg = np.zeros((k + 1, n), np.int64)
    for j in range(n):
        dp[1, j] = seg_waste(0, j)
    for kk in range(2, k + 1):
        for j in range(kk - 1, n):
            # last segment starts at s+1
            best, bs = INF, kk - 2
            for s in range(kk - 2, j):
                c = dp[kk - 1, s] + seg_waste(s + 1, j)
                if c < best:
                    best, bs = c, s
            dp[kk, j] = best
            arg[kk, j] = bs
    # backtrack
    bounds = []
    j = n - 1
    for kk in range(k, 0, -1):
        bounds.append(float(q[j]) * hop_sec)
        j = int(arg[kk, j])
    bounds = sorted(bounds)
    return bounds, dp[k, n - 1] * hop_sec


def waste_for_bounds(durs: np.ndarray, bounds) -> float:
    bounds = np.asarray(sorted(bounds), np.float64)
    idx = np.searchsorted(bounds, durs, side="left")
    idx = np.clip(idx, 0, len(bounds) - 1)
    padded = bounds[idx]
    # utterances longer than the last bound pad to it anyway (the
    # sampler drops or truncates them; count their overflow as zero)
    return float(np.maximum(padded - durs, 0.0).sum())


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--manifest", help="JSONL manifest path")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic utterances instead of a manifest")
    p.add_argument("--buckets", type=int, default=4)
    p.add_argument("--compare", default="2.0,4.0",
                   help="comma-separated bounds to compare against")
    p.add_argument("--perturb", default="",
                   help="comma-separated speed factors (e.g. 0.9,1.0,1.1): "
                        "tune on the REALIZED duration mixture the "
                        "sampler's per-epoch placement sees (each "
                        "utterance contributes duration/f per factor)")
    args = p.parse_args()

    from gluon_e2e_asr.data.manifest import (
        build_synthetic_manifest, load_manifest,
    )

    if args.synthetic:
        utts = build_synthetic_manifest(args.synthetic, seed=0)
    elif args.manifest:
        utts = load_manifest(args.manifest)
    else:
        p.error("need --manifest or --synthetic")
    durs = np.asarray([u.duration for u in utts], np.float64)
    if args.perturb:
        factors = [float(f) for f in args.perturb.split(",")]
        durs = np.concatenate([durs / f for f in factors])

    bounds, waste = optimal_bounds(durs, args.buckets)
    cur = [float(x) for x in args.compare.split(",")]
    total = float(durs.sum())
    print(f"utterances: {len(durs)}  total audio: {total:.1f}s  "
          f"mean {durs.mean():.2f}s  p95 {np.percentile(durs, 95):.2f}s")
    print(f"proposed ({args.buckets} buckets): "
          f"bucket_bounds_sec: [{', '.join(f'{b:.2f}' for b in bounds)}]")
    print(f"  padding waste {waste:.1f}s = {100 * waste / total:.1f}% "
          f"of audio")
    cw = waste_for_bounds(durs, cur)
    print(f"compare {cur}: waste {cw:.1f}s = {100 * cw / total:.1f}%")


if __name__ == "__main__":
    main()
