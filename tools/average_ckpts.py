#!/usr/bin/env python
"""Average model parameters over several checkpoints.

Snapshot averaging is the reference family's standard decode-time trick
(ESPnet-style ``--average`` over the last/best N epochs): the averaged
weights sit in a flatter part of the loss surface and typically decode
better than any single snapshot [SURVEY.md §2.1 #18 "best-model
selection" — this tool extends it with the canonical companion recipe].

Operates purely at the msgpack level (no model construction needed):
float parameter leaves are averaged elementwise across checkpoints;
everything else (optimizer state, step counter, PRNG key, CMVN stats)
is taken from the NEWEST input so the result remains a valid training
checkpoint for warm-starting as well as decoding.

Usage:
  python tools/average_ckpts.py --out avg.msgpack ck1.msgpack ck2.msgpack ...
  python tools/average_ckpts.py --out avg.msgpack --last 3 --ckpt-dir ckpts/
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gluon_e2e_asr.utils import serialization  # noqa: E402

_CKPT_RE = re.compile(r"ckpt_(\d+)\.msgpack$")


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _tree_mean(trees):
    """Elementwise mean over identical pytrees; float leaves only (ints
    and non-arrays are taken from the first/newest tree)."""
    first = trees[0]
    if isinstance(first, dict):
        return {
            k: _tree_mean([t[k] for t in trees]) for k in first
        }
    if isinstance(first, (list, tuple)):
        return type(first)(
            _tree_mean([t[i] for t in trees]) for i in range(len(first))
        )
    if isinstance(first, np.ndarray) and np.issubdtype(
            first.dtype, np.floating):
        # Accumulate in f64 then cast back: N snapshots of bf16/f32
        # weights must not lose mass to summation order.
        acc = np.zeros(first.shape, np.float64)
        for t in trees:
            acc += np.asarray(t, np.float64)
        return (acc / len(trees)).astype(first.dtype)
    return first


def ordered_last_ckpts(ckpt_dir: str, n: int):
    """The ``n`` newest step-numbered checkpoints in a dir, oldest first."""
    found = []
    for fn in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fn)
        if m:
            found.append((int(m.group(1)), os.path.join(ckpt_dir, fn)))
    found.sort()
    return [p for _, p in found[-n:]]


def ordered_best_ckpts(ckpt_dir: str, n: int):
    """The ``n`` lowest-dev-WER checkpoints (sidecar ``dev_wer``),
    oldest first — the pool ``train.keep_policy=best`` retains
    [VERDICT.md round-2 item 7]. Checkpoints without a dev_wer sidecar
    (mid-epoch saves) are excluded."""
    found = []
    for fn in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fn)
        if not m:
            continue
        path = os.path.join(ckpt_dir, fn)
        # Tolerate corrupt/partial sidecars (bad JSON, non-numeric
        # dev_wer) the same way training/checkpoint.py::_prune does —
        # skip the checkpoint, don't crash the tool [ADVICE.md round-3].
        try:
            with open(path + ".json") as f:
                w = float(json.load(f).get("dev_wer"))
        except (OSError, ValueError, TypeError, json.JSONDecodeError):
            w = None
        if w is not None:
            found.append((w, int(m.group(1)), path))
    found.sort()
    best = found[:n]
    return [p for _, _, p in sorted(best, key=lambda t: t[1])]


def average_checkpoints(paths, out_path: str) -> dict:
    """Average ``paths`` (oldest..newest) into ``out_path``. Returns the
    sidecar meta written next to it."""
    if len(paths) < 2:
        raise ValueError(f"need >= 2 checkpoints to average, got {paths}")
    payloads = [_load(p) for p in paths]
    newest = payloads[-1]
    out = dict(newest)
    out["state"] = dict(newest["state"])
    out["state"]["params"] = _tree_mean(
        [p["state"]["params"] for p in payloads])
    blob = serialization.msgpack_serialize(out)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, out_path)
    meta = {}
    newest_meta = paths[-1] + ".json"
    if os.path.exists(newest_meta):
        with open(newest_meta) as f:
            meta = json.load(f)
    meta["averaged_from"] = [os.path.basename(p) for p in paths]
    mtmp = out_path + ".json.tmp"
    with open(mtmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(mtmp, out_path + ".json")
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpts", nargs="*", help="checkpoint paths to average")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt-dir", default="",
                    help="with --last: directory holding ckpt_<step>.msgpack")
    ap.add_argument("--last", type=int, default=0,
                    help="average the N newest step-numbered ckpts in "
                         "--ckpt-dir")
    ap.add_argument("--best", type=int, default=0,
                    help="average the N lowest-dev-WER ckpts in --ckpt-dir "
                         "(sidecar dev_wer; pairs with "
                         "train.keep_policy=best)")
    args = ap.parse_args(argv)
    paths = list(args.ckpts)
    if args.last > 0 and args.best > 0:
        ap.error("--last and --best are mutually exclusive")
    if args.last > 0:
        if not args.ckpt_dir:
            ap.error("--last requires --ckpt-dir")
        paths = ordered_last_ckpts(args.ckpt_dir, args.last)
    if args.best > 0:
        if not args.ckpt_dir:
            ap.error("--best requires --ckpt-dir")
        paths = ordered_best_ckpts(args.ckpt_dir, args.best)
    meta = average_checkpoints(paths, args.out)
    print(json.dumps({
        "event": "average_ckpts",
        "inputs": [os.path.basename(p) for p in paths],
        "out": args.out,
        "step": meta.get("step"),
    }))


if __name__ == "__main__":
    main()
