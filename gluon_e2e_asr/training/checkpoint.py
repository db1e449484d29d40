"""Checkpoint / resume.

Reference-side realization: MXNet ``.params`` save + Python state
[SURVEY.md §2.1 #18, INFERRED-high]. New-repo realization: a flat
msgpack snapshot (utils/serialization.py) of {params, opt_state, step, PRNG
key, CMVN stats} plus a sidecar JSON with {config hash, vocab, epoch,
sampler position, best WER}. Deterministic resume is what makes "WER
parity" auditable [BASELINE.json:L2; SURVEY.md §5 checkpoint/resume].
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np

from gluon_e2e_asr.training.train_step import TrainState
from gluon_e2e_asr.utils import serialization

_CKPT_RE = re.compile(r"ckpt_(\d+)\.msgpack$")


def save_checkpoint(
    ckpt_dir: str,
    state: TrainState,
    meta: Dict[str, Any],
    cmvn_stats=None,
    keep: int = 3,
    is_best: bool = False,
    keep_policy: str = "last",
) -> str:
    """Save a checkpoint and prune per the retention policy.

    ``keep_policy="last"`` keeps the most recent ``keep`` checkpoints
    (plus the best symlink target). ``keep_policy="best"`` keeps the
    ``keep`` checkpoints with the LOWEST ``dev_wer`` in their sidecar
    meta (plus the newest checkpoint, which resume needs) — the pool
    ``tools/average_ckpts.py`` is designed for [VERDICT.md round-2
    item 7: last-K retention late-biases the averaging pool].
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    step = int(state.step)
    payload = {
        "state": serialization.to_state_dict(jax.device_get(state)),
        "cmvn": None
        if cmvn_stats is None
        else [np.asarray(x) for x in cmvn_stats],
    }
    blob = serialization.msgpack_serialize(payload)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.msgpack")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    # Sidecar meta gets the same tmp+rename discipline as the payload: a
    # crash mid-write must never leave a corrupt .json next to a valid
    # checkpoint (crash-only design, SURVEY.md §5 failure recovery).
    meta_tmp = path + ".json.tmp"
    with open(meta_tmp, "w") as f:
        json.dump(dict(meta, step=step), f, indent=2)
    os.replace(meta_tmp, path + ".json")
    if is_best:
        best = os.path.join(ckpt_dir, "best.msgpack")
        for suffix in ("", ".json"):
            link = best + suffix
            if os.path.lexists(link):
                os.remove(link)
            os.symlink(os.path.basename(path) + suffix, link)
    _prune(ckpt_dir, keep, keep_policy)
    return path


def _prune(ckpt_dir: str, keep: int, keep_policy: str = "last") -> None:
    if keep <= 0:
        return
    ckpts = []
    for fn in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fn)
        if m:
            ckpts.append((int(m.group(1)), fn))
    ckpts.sort()
    best_target = None
    best = os.path.join(ckpt_dir, "best.msgpack")
    if os.path.islink(best):
        best_target = os.readlink(best)
    if keep_policy == "last":
        drop = [fn for _, fn in ckpts[:-keep]]
    elif keep_policy == "best":
        # Rank by sidecar dev_wer (missing/mid-epoch metas rank worst);
        # always retain the newest checkpoint — resume depends on it.
        def dev_wer(fn: str) -> float:
            try:
                with open(os.path.join(ckpt_dir, fn + ".json")) as f:
                    v = json.load(f).get("dev_wer")
                return float(v) if v is not None else float("inf")
            except (OSError, ValueError):
                return float("inf")

        newest = ckpts[-1][1]
        ranked = sorted(
            (fn for _, fn in ckpts), key=lambda fn: (dev_wer(fn), fn)
        )
        keep_set = set(ranked[:keep]) | {newest}
        drop = [fn for _, fn in ckpts if fn not in keep_set]
    else:
        raise ValueError(f"unknown keep_policy {keep_policy!r}")
    for fn in drop:
        if fn == best_target:
            continue
        for suffix in ("", ".json"):
            p = os.path.join(ckpt_dir, fn + suffix)
            if os.path.exists(p):
                os.remove(p)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = []
    for fn in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fn)
        if m:
            ckpts.append((int(m.group(1)), fn))
    if not ckpts:
        return None
    ckpts.sort()
    return os.path.join(ckpt_dir, ckpts[-1][1])


def restore_checkpoint(
    path: str, template: TrainState, params_only: bool = False
) -> Tuple[TrainState, Optional[tuple], Dict[str, Any]]:
    """Restore (state, cmvn_stats, meta) from ``path`` using ``template``
    for pytree structure.

    ``params_only=True`` restores just the model parameters (+ step) and
    keeps the template's optimizer/PRNG state — the inference-side mode:
    decode/transcribe must load checkpoints regardless of which
    optimizer (adam's 3-element vs adadelta's inject-wrapped 4-element
    opt_state) or accumulation recipe trained them, so they must not
    depend on reconstructing the training-time opt_state structure.
    """
    with open(path, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    if params_only:
        sd = payload["state"]
        state = template.replace(
            params=serialization.from_state_dict(
                template.params, sd["params"]),
            step=serialization.from_state_dict(template.step, sd["step"]),
        )
    else:
        state = serialization.from_state_dict(template, payload["state"])
    cmvn = payload.get("cmvn")
    if cmvn is not None:
        cmvn = tuple(np.asarray(x) for x in cmvn)
    meta = {}
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, cmvn, meta
