"""LSTM language model for shallow-fusion beam decoding.

Reference-side realization: the hybrid CTC/attention family's external
RNN-LM (a Gluon ``rnn.LSTM`` over characters trained on transcript
text, mixed into the beam score as ``beta * log p_lm``) — the third
term of the canonical Watanabe-style joint decoding objective
[SURVEY.md §2.1 #17 "canonical Watanabe-style hybrid decoding";
INFERRED-med: BASELINE.json names only the CTC-prefix + attention
terms, so LM fusion ships OFF by default (``decode.lm_weight: 0.0``)
and the default decode path is bit-identical with or without this
module].

Realization: the same XLA-scanned LSTM primitives as the
encoder/decoder [BASELINE.json:L5 "XLA-scanned layers"] — the full
teacher-forced pass projects every timestep's input in one [B*L, E]
matmul and scans only the [B, H] recurrent update (``lstm_scan``); the
beam feeds one token per step through ``step`` (``lstm_cell_step``),
which carries (h, c) per (batch*beam) exactly like the attention
decoder's beam state. ``step``/``__call__`` parity is pinned by
tests/test_lm.py.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.models.lstm import lstm_cell_step, lstm_scan
from gluon_e2e_asr.models.module import (
    Module, ParamKeys, Params, lecun_normal, normal, orthogonal, zeros,
)
from gluon_e2e_asr.utils import serialization


class LSTMLM(Module):
    """Character (token) LSTM LM: embed -> stacked LSTM -> vocab logits.

    Convention (matches the attention decoder's token stream, so the
    beam can feed the SAME ``tok_in`` to both): inputs start with
    ``sos``; targets are the transcript tokens followed by ``eos``.
    ``log p_lm(eos | y)`` therefore falls out of the same projection
    that scores continuations, which is what the fused eos term in the
    beam needs.
    """

    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 hidden: int = 512, layers: int = 2):
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.hidden = hidden
        self.layers = layers

    def init_params(self, keys: ParamKeys, *inputs) -> Params:
        V, E, H = self.vocab_size, self.embed_dim, self.hidden
        p: Params = {"embed": keys(normal(1.0 / (E ** 0.5)), (V, E))}
        in_dims = [E] + [H] * (self.layers - 1)
        for l in range(self.layers):
            p[f"cell{l}_wx"] = keys(lecun_normal, (in_dims[l], 4 * H))
        for l in range(self.layers):
            p[f"cell{l}_b"] = keys(zeros, (4 * H,))
        for l in range(self.layers):
            p[f"cell{l}_wh"] = keys(orthogonal, (H, 4 * H))
        p["out_w"] = keys(lecun_normal, (H, V))
        p["out_b"] = keys(zeros, (V,))
        return p

    def __call__(self, p, tokens_in: jnp.ndarray, lens: jnp.ndarray):
        """Teacher-forced pass. tokens_in [B, L] (row 0 = sos), lens [B]
        (number of VALID input positions) -> logits [B, L, V]."""
        x = p["embed"][tokens_in]  # [B, L, E]
        for l in range(self.layers):
            xg = (
                jnp.dot(x, p[f"cell{l}_wx"],
                        preferred_element_type=jnp.float32)
                + p[f"cell{l}_b"]
            )  # [B, L, 4H] — the one big matmul per layer
            x = lstm_scan(xg, lens, p[f"cell{l}_wh"])
        return (
            jnp.dot(x, p["out_w"], preferred_element_type=jnp.float32)
            + p["out_b"]
        )

    def init_state(self, p, n: int) -> Dict[str, jnp.ndarray]:
        H = self.hidden
        return {
            "h": jnp.zeros((self.layers, n, H), jnp.float32),
            "c": jnp.zeros((self.layers, n, H), jnp.float32),
        }

    def step(self, p, state, token: jnp.ndarray):
        """One step for [n] flattened rows (the beam's batch*beam axis).
        token [n] -> (new_state, logits [n, V])."""
        x = p["embed"][token]
        hs, cs = [], []
        for l in range(self.layers):
            xg = (
                jnp.dot(x, p[f"cell{l}_wx"],
                        preferred_element_type=jnp.float32)
                + p[f"cell{l}_b"]
            )
            h_new, c_new = lstm_cell_step(
                state["h"][l], state["c"][l], xg, p[f"cell{l}_wh"]
            )
            hs.append(h_new)
            cs.append(c_new)
            x = h_new
        logits = (
            jnp.dot(x, p["out_w"], preferred_element_type=jnp.float32)
            + p["out_b"]
        )
        return {"h": jnp.stack(hs), "c": jnp.stack(cs)}, logits


def build_lm(config, vocab_size: int) -> LSTMLM:
    lc = config.lm
    return LSTMLM(
        vocab_size=vocab_size,
        embed_dim=lc.embed_dim,
        hidden=lc.hidden,
        layers=lc.layers,
    )


# ----------------------------------------------------------------------
# Checkpoint I/O (standalone: an LM ckpt is self-describing so decode
# can restore it from a path alone — same msgpack + JSON-sidecar
# discipline as training/checkpoint.py, incl. tmp+rename crash safety).
# ----------------------------------------------------------------------

def save_lm(path: str, params, meta: Dict[str, Any]) -> str:
    """``meta`` must carry the architecture (vocab_size/embed_dim/
    hidden/layers) and should carry the vocab JSON for a mismatch
    check at fusion time."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = serialization.msgpack_serialize(
        {"params": serialization.to_state_dict(jax.device_get(params))}
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    meta_tmp = path + ".json.tmp"
    with open(meta_tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_tmp, path + ".json")
    return path


def load_lm(path: str) -> Tuple[LSTMLM, Any, Dict[str, Any]]:
    """Restore (model, params, meta) from a ``save_lm`` checkpoint."""
    with open(path + ".json") as f:
        meta = json.load(f)
    model = LSTMLM(
        vocab_size=int(meta["vocab_size"]),
        embed_dim=int(meta["embed_dim"]),
        hidden=int(meta["hidden"]),
        layers=int(meta["layers"]),
    )
    with open(path, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    template = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))[
        "params"]
    params = serialization.from_state_dict(template, payload["params"])
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return model, params, meta


def lm_logprob_batch(model: LSTMLM, params, token_rows, eos_id: int,
                     sos_id: int, pad_to: int = 16,
                     max_rows: int = 2048) -> np.ndarray:
    """Exact sequence log-probs for MANY id rows in a few jitted calls:
    log p(y, eos | sos) per row. Rows pad to a shared length rounded up
    to a multiple of ``pad_to`` so repeated calls reuse a handful of
    compiled shapes (per-row ``lm_logprob`` would recompile per length).

    Rows are processed in ``max_rows`` chunks (short rows padded up to
    the chunk size, one compiled shape per length class): a single call
    over the whole set materializes [n, L, V] f32 logits, which grows
    without bound with the candidate count (27,000 rescoring candidates
    at the 100 h scale are 16.5 GB)."""
    n = len(token_rows)
    if n == 0:
        return np.zeros((0,), np.float32)
    L = max(len(r) for r in token_rows) + 1  # +1 for the eos target
    L = ((L + pad_to - 1) // pad_to) * pad_to
    out = np.zeros((n,), np.float32)
    for start in range(0, n, max_rows):
        rows = token_rows[start: start + max_rows]
        m = len(rows)
        mp = max_rows if n > max_rows else m  # stable chunk shape
        tokens_in = np.zeros((mp, L), np.int32)
        targets = np.zeros((mp, L), np.int32)
        lens = np.zeros((mp,), np.int32)
        for i, row in enumerate(rows):
            ids = [int(t) for t in row][: L - 1]
            seq_in = [sos_id] + ids
            seq_tgt = ids + [eos_id]
            tokens_in[i, : len(seq_in)] = seq_in
            targets[i, : len(seq_tgt)] = seq_tgt
            lens[i] = len(seq_in)
        logits = model.apply({"params": params}, jnp.asarray(tokens_in),
                             jnp.asarray(lens))
        logp = jax.nn.log_softmax(logits, axis=-1)
        tok_lp = jnp.take_along_axis(logp, jnp.asarray(targets)[..., None],
                                     axis=-1)[..., 0]
        mask = jnp.arange(L)[None, :] < jnp.asarray(lens)[:, None]
        out[start: start + m] = np.asarray(
            jnp.sum(tok_lp * mask, axis=1))[:m]
    return out


def lm_logprob(model: LSTMLM, params, tokens: np.ndarray,
               eos_id: int, sos_id: int) -> float:
    """Host-side exact sequence log-probability (for tests and n-best
    rescoring): log p(y, eos | sos) summed over one unpadded id row."""
    ids = [int(t) for t in tokens]
    tokens_in = jnp.asarray([[sos_id] + ids], jnp.int32)
    L = len(ids) + 1
    logits = model.apply(
        {"params": params}, tokens_in, jnp.asarray([L], jnp.int32)
    )[0]
    logp = jax.nn.log_softmax(logits, axis=-1)
    targets = ids + [eos_id]
    return float(sum(logp[i, t] for i, t in enumerate(targets)))
