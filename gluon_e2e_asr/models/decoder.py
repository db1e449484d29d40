"""LAS-style attention decoder (unidirectional LSTM + attention).

Reference-side realization: Gluon Blocks over MXNet C++ ops with a
Python per-step loop [SURVEY.md §2.1 #10,#12]. New-repo realization
[BASELINE.json:L9]: one model with two apply paths sharing the same
parameters —

  * ``__call__``  — the teacher-forced training pass as a single
    ``lax.scan`` over output steps, with scheduled sampling (per-step
    Bernoulli mix of gold vs the model's own argmax, PRNG-keyed)
    [SURVEY.md §2.1 #12];
  * ``step``      — a single decode step over an explicit state pytree,
    used by greedy/beam search [SURVEY.md §3.2]. Scan-path vs step-path
    parity is unit-tested.

Attention variants: "dot" (scaled dot product), "add" (Bahdanau), and
"loc" (location-aware: additive + a conv feature over the previous
attention weights) [SURVEY.md §2.1 #10, INFERRED-med on variant].
The encoder-side key projection is precomputed once per utterance
(``precompute``) so the per-step work is one cell update + one masked
softmax — the big matmuls stay outside the scan.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from gluon_e2e_asr.config import ModelConfig
from gluon_e2e_asr.models.lstm import lstm_cell_step
from gluon_e2e_asr.models.module import (
    Module, ParamKeys, Params, lecun_normal, normal, orthogonal, zeros,
)


class AttentionDecoder(Module):
    def __init__(self, cfg: ModelConfig, vocab_size: int, sos_id: int = 2,
                 eos_id: int = 3):
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.sos_id = sos_id
        self.eos_id = eos_id

    def init_params(self, keys: ParamKeys, *inputs, **kwargs) -> Params:
        cfg = self.cfg
        V, E, H, A = self.vocab_size, cfg.dec_embed, cfg.dec_hidden, cfg.att_dim
        enc_dim = 2 * cfg.enc_hidden
        L = cfg.dec_layers
        p: Params = {"embed": keys(normal(1.0 / (E ** 0.5)), (V, E))}
        # Stacked LSTM cells; layer 0 consumes [embedding ; context].
        in_dims = [E + enc_dim] + [H] * (L - 1)
        for l in range(L):
            p[f"cell{l}_wx"] = keys(lecun_normal, (in_dims[l], 4 * H))
        for l in range(L):
            p[f"cell{l}_b"] = keys(zeros, (4 * H,))
        for l in range(L):
            p[f"cell{l}_wh"] = keys(orthogonal, (H, 4 * H))
        # Attention parameters.
        p["att_q"] = keys(lecun_normal, (H, A))
        p["att_k"] = keys(lecun_normal, (enc_dim, A))
        if cfg.att_type in ("add", "loc"):
            p["att_b"] = keys(zeros, (A,))
            p["att_v"] = keys(lecun_normal, (A, 1))
        if cfg.att_type == "loc":
            p["loc_filter"] = keys(
                lecun_normal, (cfg.loc_conv_width, 1, cfg.loc_conv_channels))
            p["loc_proj"] = keys(lecun_normal, (cfg.loc_conv_channels, A))
        p["out_w"] = keys(lecun_normal, (H + enc_dim, V))
        p["out_b"] = keys(zeros, (V,))
        return p

    # ------------------------------------------------------------------
    # Attention
    # ------------------------------------------------------------------
    def precompute(self, p, enc: jnp.ndarray) -> jnp.ndarray:
        """Encoder key projection, computed once per utterance: [B,T,A]."""
        cdtype = jnp.dtype(self.cfg.compute_dtype)
        return jnp.dot(
            enc.astype(cdtype), p["att_k"].astype(cdtype),
            preferred_element_type=jnp.float32,
        )

    def build_loc_band(self, p, T: int) -> jnp.ndarray:
        """Banded matrix realizing the location conv as one matmul.

        A ``conv_general_dilated`` inside the decode scan (and its
        backward) lowers poorly inside lax.scan. Same math as a matmul:
        out[n,t,c] = sum_s att[n,s] * Band[s,(t,c)] with
        Band[s,t,c] = filter[s - t + (w-1)//2, 0, c] (XLA SAME alignment,
        verified empirically). MUST be built OUTSIDE any scan (the gather
        and its scatter-backward are per-call costs); callers pass it into
        step/step_beam. Returns [T, T*C], or None when the band would be
        too large (long buckets: T*T*C floats) — callers then fall back
        to the conv path."""
        cfg = self.cfg
        if T * T * cfg.loc_conv_channels > 16_000_000:  # > 64 MB f32
            return None
        w = cfg.loc_conv_width
        pad_left = (w - 1) // 2
        s_idx = jnp.arange(T)[:, None]
        t_idx = jnp.arange(T)[None, :]
        k = s_idx - t_idx + pad_left  # [T,T]
        valid = (k >= 0) & (k < w)
        gathered = p["loc_filter"][jnp.clip(k, 0, w - 1), 0, :]  # [T,T,C]
        band = jnp.where(valid[..., None], gathered, 0.0)
        return band.reshape(T, T * cfg.loc_conv_channels)

    def _loc_feature(self, p, att_prev_flat: jnp.ndarray, loc_band) -> jnp.ndarray:
        """att_prev_flat [N, T] -> [N, T, C]: banded matmul when a band is
        available, conv otherwise (long-bucket fallback)."""
        T = att_prev_flat.shape[-1]
        if loc_band is not None:
            out = jnp.dot(
                att_prev_flat, loc_band, preferred_element_type=jnp.float32
            )
            return out.reshape(att_prev_flat.shape[0], T,
                               self.cfg.loc_conv_channels)
        return jax.lax.conv_general_dilated(
            att_prev_flat[:, :, None],
            p["loc_filter"],
            window_strides=(1,),
            padding="SAME",
            dimension_numbers=("NWC", "WIO", "NWC"),
        )

    def _attend(self, p, query, enc, enc_proj, enc_mask, att_prev,
                loc_band=None):
        """query [B,H] -> (context [B,enc_dim], att_w [B,T])."""
        cfg = self.cfg
        q = jnp.dot(query, p["att_q"], preferred_element_type=jnp.float32)  # [B,A]
        if cfg.att_type == "dot":
            scores = jnp.einsum("ba,bta->bt", q, enc_proj) / jnp.sqrt(
                jnp.asarray(cfg.att_dim, jnp.float32)
            )
        else:
            e = q[:, None, :] + enc_proj + p["att_b"]  # [B,T,A]
            if cfg.att_type == "loc":
                # Location feature over previous attention weights
                # [B,T] -> [B,T,C], as a banded matmul (see build_loc_band).
                f = self._loc_feature(p, att_prev, loc_band)
                e = e + jnp.dot(f, p["loc_proj"],
                                preferred_element_type=jnp.float32)
            scores = jnp.tanh(e) @ p["att_v"]  # [B,T,1]
            scores = scores[..., 0]
        scores = jnp.where(enc_mask, scores, -1e30)
        att_w = jax.nn.softmax(scores, axis=-1)
        att_w = att_w * enc_mask  # exact zeros on padding
        context = jnp.einsum("bt,btd->bd", att_w, enc)
        return context, att_w

    # ------------------------------------------------------------------
    # Single decode step (shared by training scan, greedy, beam)
    # ------------------------------------------------------------------
    def init_state(self, p, batch: int, enc_frames: int) -> Dict[str, Any]:
        cfg = self.cfg
        H, enc_dim = cfg.dec_hidden, 2 * cfg.enc_hidden
        z = lambda *s: jnp.zeros(s, jnp.float32)
        # Initial attention: uniform over the (masked) window would need
        # lens; zeros work because step() recomputes attention before use.
        return {
            "h": z(cfg.dec_layers, batch, H),
            "c": z(cfg.dec_layers, batch, H),
            "att_w": z(batch, enc_frames),
            "context": z(batch, enc_dim),
        }

    def step(self, p, state, token, enc, enc_proj, enc_mask, loc_band=None):
        """One decode step. token [B] int32 -> (new_state, logits [B,V]).
        For loc attention inside a scan, pass a prebuilt ``loc_band``
        (build_loc_band) — building it per step is pathological."""
        cfg = self.cfg
        emb = p["embed"][token]  # [B,E]
        x = jnp.concatenate([emb, state["context"]], axis=-1)
        hs, cs = [], []
        for l in range(cfg.dec_layers):
            xg = jnp.dot(x, p[f"cell{l}_wx"],
                         preferred_element_type=jnp.float32) + p[f"cell{l}_b"]
            h_new, c_new = lstm_cell_step(
                state["h"][l], state["c"][l], xg, p[f"cell{l}_wh"]
            )
            hs.append(h_new)
            cs.append(c_new)
            x = h_new
        query = hs[-1]
        context, att_w = self._attend(p, query, enc, enc_proj, enc_mask,
                                      state["att_w"], loc_band)
        logits = (
            jnp.dot(jnp.concatenate([query, context], axis=-1), p["out_w"],
                    preferred_element_type=jnp.float32)
            + p["out_b"]
        )
        new_state = {
            "h": jnp.stack(hs),
            "c": jnp.stack(cs),
            "att_w": att_w,
            "context": context,
        }
        return new_state, logits

    # ------------------------------------------------------------------
    # Beam-layout step: encoder tensors stay [B,T,*] (NOT replicated
    # K-fold); only the small decoder state carries the beam axis.
    # ------------------------------------------------------------------
    def _attend_beam(self, p, query, enc, enc_proj, enc_mask, att_prev,
                     loc_band=None):
        """query [B,K,H], enc [B,T,D], enc_proj [B,T,A], enc_mask [B,T],
        att_prev [B,K,T] -> (context [B,K,D], att_w [B,K,T])."""
        cfg = self.cfg
        B, K, _ = query.shape
        T = enc.shape[1]
        q = jnp.einsum("bkh,ha->bka", query, p["att_q"])
        if cfg.att_type == "dot":
            scores = jnp.einsum("bka,bta->bkt", q, enc_proj) / jnp.sqrt(
                jnp.asarray(cfg.att_dim, jnp.float32)
            )
        else:
            e = q[:, :, None, :] + enc_proj[:, None, :, :] + p["att_b"]
            if cfg.att_type == "loc":
                f = self._loc_feature(p, att_prev.reshape(B * K, T), loc_band)
                e = e + jnp.dot(
                    f, p["loc_proj"], preferred_element_type=jnp.float32
                ).reshape(B, K, T, -1)
            scores = (jnp.tanh(e) @ p["att_v"])[..., 0]  # [B,K,T]
        scores = jnp.where(enc_mask[:, None, :] > 0, scores, -1e30)
        att_w = jax.nn.softmax(scores, axis=-1) * enc_mask[:, None, :]
        context = jnp.einsum("bkt,btd->bkd", att_w, enc)
        return context, att_w

    def init_state_beam(self, p, batch: int, beams: int, enc_frames: int):
        cfg = self.cfg
        H, enc_dim = cfg.dec_hidden, 2 * cfg.enc_hidden
        z = lambda *s: jnp.zeros(s, jnp.float32)
        return {
            "h": z(cfg.dec_layers, batch * beams, H),
            "c": z(cfg.dec_layers, batch * beams, H),
            "att_w": z(batch, beams, enc_frames),
            "context": z(batch * beams, enc_dim),
        }

    def step_beam(self, p, state, token, enc, enc_proj, enc_mask, beams: int,
                  loc_band=None):
        """One decode step over [B*K] flattened beams with shared encoder
        tensors. token [B*K] -> (new_state, logits [B*K, V])."""
        cfg = self.cfg
        B = enc.shape[0]
        emb = p["embed"][token]
        x = jnp.concatenate([emb, state["context"]], axis=-1)
        hs, cs = [], []
        for l in range(cfg.dec_layers):
            xg = jnp.dot(x, p[f"cell{l}_wx"],
                         preferred_element_type=jnp.float32) + p[f"cell{l}_b"]
            h_new, c_new = lstm_cell_step(
                state["h"][l], state["c"][l], xg, p[f"cell{l}_wh"]
            )
            hs.append(h_new)
            cs.append(c_new)
            x = h_new
        query = hs[-1].reshape(B, beams, -1)
        context, att_w = self._attend_beam(
            p, query, enc, enc_proj, enc_mask, state["att_w"], loc_band
        )
        context_flat = context.reshape(B * beams, -1)
        logits = (
            jnp.dot(
                jnp.concatenate([hs[-1], context_flat], axis=-1),
                p["out_w"],
                preferred_element_type=jnp.float32,
            )
            + p["out_b"]
        )
        new_state = {
            "h": jnp.stack(hs),
            "c": jnp.stack(cs),
            "att_w": att_w,
            "context": context_flat,
        }
        return new_state, logits

    # ------------------------------------------------------------------
    # Teacher-forced training pass (lax.scan) with scheduled sampling
    # ------------------------------------------------------------------
    def __call__(
        self,
        p: Params,
        enc: jnp.ndarray,  # [B,T,enc_dim]
        enc_len: jnp.ndarray,  # [B]
        tokens_in: jnp.ndarray,  # [B,L] gold inputs, tokens_in[:,0] == sos
        ss_prob: float = 0.0,
        ss_rng=None,
    ) -> jnp.ndarray:
        """Returns logits [B, L, V] predicting tokens_in shifted by one."""
        B, T = enc.shape[0], enc.shape[1]
        L = tokens_in.shape[1]
        enc_mask = (jnp.arange(T)[None, :] < enc_len[:, None]).astype(jnp.float32)
        enc_proj = self.precompute(p, enc)

        # ss_prob may be a traced scalar (the per-step sampling-ratio ramp,
        # SURVEY.md §2.1 #12); gate the branch statically: compiled out only
        # when ss_prob is a Python number <= 0 or no key was given.
        static_off = isinstance(ss_prob, (int, float)) and ss_prob <= 0.0
        use_ss = ss_rng is not None and not static_off
        if use_ss:
            coins = jax.random.bernoulli(ss_rng, ss_prob, (L, B))
        else:
            coins = jnp.zeros((L, B), bool)

        # Built once, closure-captured: scan treats it as loop-invariant.
        loc_band = (self.build_loc_band(p, T)
                    if self.cfg.att_type == "loc" else None)
        state0 = self.init_state(p, B, T)

        def scan_step(carry, inp):
            state, prev_pred = carry
            gold_tok, coin = inp
            tok = jnp.where(coin, prev_pred, gold_tok)
            state, logits = self.step(p, state, tok, enc, enc_proj, enc_mask,
                                      loc_band)
            pred = jnp.argmax(logits, axis=-1).astype(tokens_in.dtype)
            return (state, pred), logits

        # Step 0 always consumes sos (coins[0] forced False).
        coins = coins.at[0].set(False)
        init = (state0, tokens_in[:, 0])
        _, logits = jax.lax.scan(
            scan_step, init, (tokens_in.T, coins)
        )  # [L, B, V]
        return jnp.swapaxes(logits, 0, 1)
