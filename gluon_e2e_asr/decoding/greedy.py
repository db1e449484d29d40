"""Greedy CTC decoding (milestone 1) [BASELINE.json:L7; SURVEY.md §2.1 #16].

One jitted pass: frontend -> encoder -> framewise argmax -> on-device
collapse (dedup + blank removal). The host only detokenizes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import Config
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.frontend.features import frontend_apply
from gluon_e2e_asr.models.asr import ASRModel
from gluon_e2e_asr.ops.ctc import ctc_greedy_decode


def make_greedy_decoder(
    model: ASRModel, config: Config, cmvn_stats=None, mesh=None
) -> Callable:
    """Returns jitted fn(params, audio, audio_len) -> (ids [B,T'], lens [B]).

    With ``mesh`` the batch axis is sharded over the ``data`` mesh axis
    (shard_map: params replicated, every sample decoded shard-locally,
    no collectives) — DP decode/eval throughput mirroring the DP train
    step [SURVEY.md §2.3; the same seam as training/train_step.py].
    """

    def decode_fn(params, audio, audio_len):
        feats, feat_len = frontend_apply(
            config.frontend, audio, audio_len, train=False, cmvn_stats=cmvn_stats
        )
        _, enc_len, ctc_logits = model.apply(
            {"params": params}, feats, feat_len, method=model.encode
        )
        return ctc_greedy_decode(ctc_logits, enc_len, blank_id=0)

    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        from gluon_e2e_asr.parallel.mesh import DATA_AXIS

        d = P(DATA_AXIS)
        # check_vma=False for the same reason as the train step: scan
        # carries start as unvarying zeros (see train_step.py).
        decode_fn = jax.shard_map(
            decode_fn, mesh=mesh,
            in_specs=(P(), d, d), out_specs=(d, d), check_vma=False,
        )
    return jax.jit(decode_fn)


def ids_to_texts(
    ids: np.ndarray, lens: np.ndarray, tokenizer: CharTokenizer
) -> List[str]:
    out = []
    for row, n in zip(np.asarray(ids), np.asarray(lens)):
        out.append(tokenizer.decode(row[: int(n)]))
    return out
