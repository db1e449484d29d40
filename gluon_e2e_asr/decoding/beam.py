"""Batched beam search with CTC prefix scoring + length normalization.

Reference-side realization: a per-utterance Python beam loop
[SURVEY.md §2.1 #17, INFERRED-high; canonical Watanabe-style hybrid
decoding]. New-repo realization prescribed by [BASELINE.json:L5,L11]:
a *batched, jitted* beam kernel —

  * fixed beam width K, vectorized over (batch, beam, vocab);
  * CTC prefix scores maintained as (nonblank, blank)-ending log-prob
    pairs r = (r_n, r_b) per hypothesis over encoder time, updated for
    ALL vocabulary extensions at once by a ``lax.scan`` over time
    (the CTCPrefixScoreTH-style vectorization of [PAPERS.md:L7]
    "Vectorization of hypotheses and speech for faster beam search",
    with batched-CTC prior art [PAPERS.md:L5,L6,L8,L9]);
  * one ``lax.scan`` over output steps; all shapes static;
  * joint ranking score = (1-w) * att_logprob_sum + w * ctc_prefix;
  * eos extensions are diverted into a fixed-size finished buffer with
    length normalization at finalization [BASELINE.json:L11];
  * per-sample max output length (maxlen_ratio * enc_len) force-closes
    beams, so one compiled program serves every utterance in a bucket.

CTC prefix recursion (log space), extending prefix g by token c:
  phi[t]   = logaddexp(r_b(g)[t], c == last(g) ? -inf : r_n(g)[t])
  r_n(h)[t] = logaddexp(r_n(h)[t-1], phi[t-1]) + x[t, c]
  r_b(h)[t] = logaddexp(r_b(h)[t-1], r_n(h)[t-1]) + x[t, blank]
  psi(h)    = logsumexp_t(phi[t-1] + x[t, c])
with phi[-1] = 0 for the empty prefix (mass 1 before any emission),
-inf otherwise; and score(eos | g) = full CTC probability of g
= logaddexp(r_n(g)[T_b-1], r_b(g)[T_b-1]).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import Config
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.frontend.features import frontend_apply
from gluon_e2e_asr.models.asr import ASRModel

NEG_INF = -1.0e30


def _logaddexp(a, b):
    m = jnp.maximum(a, b)
    m = jnp.maximum(m, NEG_INF)  # keep -inf - -inf out of exp
    return m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m))


def _ctc_extension_scores(
    ctc_logp: jnp.ndarray,  # [B, T, V] log-softmax of CTC head
    enc_len: jnp.ndarray,  # [B]
    r_prev: jnp.ndarray,  # [B, K, T, 2] (r_n, r_b) of current prefixes
    last_tok: jnp.ndarray,  # [B, K] last token of each prefix
    is_empty: jnp.ndarray,  # [B, K] bool: prefix is empty
    blank_id: int,
    cand: jnp.ndarray = None,  # [B, K, N] candidate token ids, or None
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Scores for extending every (batch, beam) prefix by every token.

    With ``cand=None`` every vocabulary token is scored (N = V below).
    With ``cand`` only those N tokens are scored per beam — the
    ESPnet-style partial scoring that keeps the per-step prefix state
    [T, B, K, N, 2] bounded at BPE-sized vocabularies.

    Returns (psi [B,K,N], r_new [T,B,K,N,2], full_prob [B,K]).
    """
    B, T, V = ctc_logp.shape
    K = r_prev.shape[1]
    xt = jnp.swapaxes(ctc_logp, 0, 1)  # [T,B,V]
    xb = xt[:, :, None, blank_id : blank_id + 1]  # [T,B,1,1]
    if cand is None:
        xs = xt[:, :, None, :]  # [T,B,1,V] (broadcasts over K)
        n_ext = V
    else:
        n_ext = cand.shape[-1]
        # Gather per-(beam, candidate) emission columns: [B,T,K,N].
        xs = jnp.moveaxis(
            jnp.take_along_axis(
                ctc_logp[:, :, None, :], cand[:, None, :, :], axis=3
            ),
            1, 0,
        )  # [T,B,K,N]
    tmask = (jnp.arange(T)[:, None] < enc_len[None, :])[:, :, None, None]

    # r(g) at t-1, prepended with the virtual t=-1 row:
    #   empty prefix: (r_n, r_b) = (-inf, 0); otherwise (-inf, -inf).
    r_g = jnp.moveaxis(r_prev, 2, 0)  # [T,B,K,2]
    rm1 = jnp.stack(
        [
            jnp.full((B, K), NEG_INF),
            jnp.where(is_empty, 0.0, NEG_INF),
        ],
        axis=-1,
    )  # [B,K,2]
    r_g_shift = jnp.concatenate([rm1[None], r_g[:-1]], axis=0)  # [T,B,K,2]

    if cand is None:
        same_as_last = (
            jax.lax.broadcasted_iota(jnp.int32, (B, K, V), 2)
            == last_tok[..., None]
        )
    else:
        same_as_last = cand == last_tok[..., None]  # [B,K,N]

    def t_step(carry, inp):
        r_n_h, r_b_h, psi = carry  # [B,K,V]
        x_t, xb_t, r_g_tm1, m_t = inp
        r_n_g, r_b_g = r_g_tm1[..., 0:1], r_g_tm1[..., 1:2]  # [B,K,1]
        phi = _logaddexp(r_b_g, jnp.where(same_as_last, NEG_INF, r_n_g))
        r_n_new = _logaddexp(r_n_h, phi) + x_t
        r_b_new = _logaddexp(r_b_h, r_n_h) + xb_t
        psi_new = _logaddexp(psi, phi + x_t)
        r_n_h2 = jnp.where(m_t, r_n_new, r_n_h)
        r_b_h2 = jnp.where(m_t, r_b_new, r_b_h)
        psi2 = jnp.where(m_t, psi_new, psi)
        return (r_n_h2, r_b_h2, psi2), jnp.stack([r_n_h2, r_b_h2], axis=-1)

    init = (
        jnp.full((B, K, n_ext), NEG_INF),
        jnp.full((B, K, n_ext), NEG_INF),
        jnp.full((B, K, n_ext), NEG_INF),
    )
    (_, _, psi), r_new = jax.lax.scan(
        t_step, init, (xs, xb, r_g_shift, tmask)
    )
    # Full CTC probability of the *current* prefix g (for eos scoring).
    t_last = jnp.maximum(enc_len - 1, 0)  # [B]
    r_at_end = jnp.take_along_axis(
        r_prev, t_last[:, None, None, None].astype(jnp.int32), axis=2
    )[:, :, 0]  # [B,K,2]
    full_prob = _logaddexp(r_at_end[..., 0], r_at_end[..., 1])
    # Empty prefix full prob: all-blank path = r_b component (already in r).
    return psi, r_new, full_prob


def make_beam_decoder(
    model: ASRModel,
    config: Config,
    tokenizer: CharTokenizer,
    cmvn_stats=None,
    mesh=None,
    lm_bundle=None,
) -> Callable:
    """Build the jitted batched beam decoder.

    Returns fn(params, audio, audio_len) -> (texts: List[str], scores).
    The device portion is fully jitted; the host only detokenizes.
    With ``mesh`` the batch axis is sharded over the ``data`` mesh axis
    (shard_map, params replicated, no collectives — every sample's beam
    runs shard-locally): DP decode for multi-chip eval/serving
    throughput, the same seam as the DP train step [SURVEY.md §2.3].
    """
    dc = config.decode
    K = dc.beam_size
    w = float(dc.ctc_weight)
    blank_id = tokenizer.blank_id
    sos_id = tokenizer.sos_id
    eos_id = tokenizer.eos_id
    unk_id = tokenizer.unk_id
    V = tokenizer.vocab_size
    # decode.method == "ctc_beam": decoder-free label-synchronous CTC
    # prefix beam search [SURVEY.md §2.1 #17 family; PAPERS.md CTC-decode
    # prior art] — each step extends every prefix by every token and
    # ranks by the EXACT prefix probability psi (which already sums over
    # all alignments, so unlike frame-synchronous prefix beams there are
    # no duplicate prefixes to merge: distinct parents yield distinct
    # children). Ranking weight is forced to w=1 (pure CTC); the
    # finalization score is the full CTC probability of the prefix.
    # Serves CTC-only models (milestone 1) and composes with LM fusion.
    use_dec = dc.method != "ctc_beam"
    if not use_dec:
        w = 1.0
    if not model.use_decoder and use_dec:
        raise ValueError(
            "beam decoding requires the attention decoder (CTC-only "
            "models decode with method=greedy or method=ctc_beam)")
    # Partial CTC scoring: restrict extensions to the top-N tokens by
    # attention log-prob per beam. Full-vocab scoring materializes
    # [T, B, K, V, 2] prefix states per step — refuse that loudly at BPE
    # vocab sizes instead of OOMing [VERDICT.md weak #6].
    n_best = max(1, min(int(getattr(dc, "nbest", 1)), K))
    penalty = float(getattr(dc, "penalty", 0.0))
    if penalty != 0.0 and dc.length_norm:
        # penalty*|h| is applied before the /|h| normalization, so its
        # contribution penalty*L/(L+1) is nearly CONSTANT across lengths
        # — measured: hypotheses identical at penalty=±5 on the m5 dev
        # set. The two knobs address the same short-hypothesis bias;
        # use penalty with length_norm: false.
        import logging

        logging.getLogger(__name__).warning(
            "decode.penalty=%g has almost no effect with "
            "decode.length_norm=true (the normalization divides the "
            "penalty term down to a near-constant offset); set "
            "length_norm: false to use the insertion penalty", penalty)
    # End detection (opt-in heuristic, Watanabe-style): a sample stops
    # expanding once M consecutive output lengths produced no finalization
    # within D raw log-prob of its best finished hypothesis — the standard
    # early stop of the reference family's beam [SURVEY.md §3.2; ROADMAP
    # item 6]. Compared on UNNORMALIZED scores (raw log-prob sums), where
    # the D margin is meaningful; exact-search semantics are preserved
    # with end_detect=false (the default).
    use_end_detect = bool(getattr(dc, "end_detect", False))
    ed_m = int(getattr(dc, "end_detect_m", 3))
    ed_d = float(getattr(dc, "end_detect_d", 10.0))
    # External-LM shallow fusion (the third term of the Watanabe-style
    # joint score, off by default): score(h) accumulates
    # lm_weight * sum_i log p_lm(y_i | y_<i), with the LM's eos
    # probability entering the finalization score exactly like the
    # attention decoder's [SURVEY.md §2.1 #17; DecodeConfig.lm_weight].
    # lm_weight == 0.0 leaves the carry/score math bit-identical to the
    # LM-free decoder (pinned by tests/test_lm.py).
    lm_w = float(getattr(dc, "lm_weight", 0.0))
    use_lm = lm_w != 0.0
    lm_model, lm_params = lm_bundle if lm_bundle is not None else (None, None)
    if use_lm and lm_model is None:
        if not dc.lm_ckpt:
            raise ValueError(
                "decode.lm_weight is set but no LM was provided: set "
                "decode.lm_ckpt (a train_lm.py checkpoint) or pass "
                "lm_bundle=(model, params)")
        from gluon_e2e_asr.models.lm import load_lm

        lm_model, lm_params, lm_meta = load_lm(dc.lm_ckpt)
        if int(lm_meta["vocab_size"]) != V:
            raise ValueError(
                f"LM vocab_size {lm_meta['vocab_size']} != decode "
                f"tokenizer vocab_size {V}")
        if lm_meta.get("vocab") and lm_meta["vocab"] != tokenizer.to_json():
            raise ValueError(
                "LM checkpoint vocab differs from the decode tokenizer "
                "(same sizes, different symbol table) — retrain the LM "
                "on this vocab")
    n_cand = int(dc.ctc_score_candidates)
    use_partial = w > 0.0 and 0 < n_cand < V
    if w > 0.0 and not use_partial and V > 512:
        raise ValueError(
            f"full-vocab CTC prefix scoring at vocab_size={V} would "
            "materialize a [T,B,K,V,2] prefix state per step; set "
            "decode.ctc_score_candidates (e.g. 2*beam_size) to enable "
            "partial scoring"
        )
    if use_partial and n_cand < K:
        raise ValueError(
            f"ctc_score_candidates={n_cand} must be >= beam_size={K} "
            "(each step keeps K continuations drawn from the candidates)"
        )

    def device_fn(params, lm_ps, audio, audio_len):
        feats, feat_len = frontend_apply(
            config.frontend, audio, audio_len, train=False,
            cmvn_stats=cmvn_stats,
        )
        enc, enc_len, ctc_logits = model.apply(
            {"params": params}, feats, feat_len, method=model.encode
        )
        B, T, D = enc.shape
        Lmax = max(int(dc.maxlen_ratio * T), 4)
        ctc_logp = jax.nn.log_softmax(ctc_logits, axis=-1)

        enc_mask = (jnp.arange(T)[None, :] < enc_len[:, None]).astype(
            jnp.float32
        )
        if use_dec:
            # Encoder tensors stay [B,T,*]; only the small decoder state
            # carries the beam axis (no K-fold replication of enc/enc_proj).
            enc_proj = model.apply(
                {"params": params}, enc, method=model.decoder_precompute
            )
            dec_state0 = model.apply(
                {"params": params}, B, K, T,
                method=model.decoder_init_state_beam
            )
            # Location-attention band matrix: built once, outside the scan.
            loc_band = model.apply(
                {"params": params}, T, method=model.decoder_loc_band
            )
        # ctc_beam + partial scoring: the candidate set is static per
        # sample (no attention scores to pre-rank by) — the top-N tokens
        # by best framewise CTC posterior over the valid frames, the
        # standard pruning for large vocabs.
        static_cand = None
        if not use_dec and use_partial:
            t_ok = (jnp.arange(T)[None, :] < enc_len[:, None])[..., None]
            post_max = jnp.max(
                jnp.where(t_ok, ctc_logp, NEG_INF), axis=1
            )  # [B,V]
            sbad = jnp.zeros((V,), bool).at[blank_id].set(True)
            sbad = sbad.at[sos_id].set(True).at[eos_id].set(True)
            sbad = sbad.at[unk_id].set(True)
            post_max = jnp.where(sbad[None, :], NEG_INF, post_max)
            _, sc = jax.lax.top_k(post_max, n_cand)  # [B,N]
            static_cand = jnp.broadcast_to(sc[:, None, :], (B, K, n_cand))

        maxlen = jnp.maximum(
            (dc.maxlen_ratio * enc_len.astype(jnp.float32)).astype(jnp.int32), 1
        )
        minlen = (dc.minlen_ratio * enc_len.astype(jnp.float32)).astype(jnp.int32)

        # CTC prefix state of the empty prefix: r_b[t] = sum_{tau<=t} x[tau,b].
        xb_cum = jnp.cumsum(ctc_logp[:, :, blank_id], axis=1)  # [B,T]
        r0 = jnp.stack(
            [jnp.full((B, T), NEG_INF), xb_cum], axis=-1
        )[:, None, :, :].repeat(K, axis=1)  # [B,K,T,2]

        init = {
            "tokens": jnp.zeros((B, K, Lmax), jnp.int32),
            "hyp_len": jnp.zeros((B, K), jnp.int32),
            "att_sum": jnp.where(
                jnp.arange(K)[None, :] == 0, 0.0, NEG_INF
            ).repeat(B, axis=0).reshape(B, K),
            "r": r0,
            "last_tok": jnp.full((B, K), -1, jnp.int32),
            "fin_tokens": jnp.zeros((B, K, Lmax), jnp.int32),
            "fin_len": jnp.zeros((B, K), jnp.int32),
            "fin_score": jnp.full((B, K), NEG_INF),
            # end-detect state: best RAW (unnormalized) finished score and
            # the count of consecutive lengths with no finalization within
            # ed_d of it. Carried (cheaply) even when end_detect is off so
            # the carry structure is stable.
            "best_raw": jnp.full((B,), NEG_INF),
            "end_cnt": jnp.zeros((B,), jnp.int32),
        }
        if use_dec:
            init["dec_state"] = dec_state0
        if use_lm:
            init["lm_state"] = lm_model.apply(
                {"params": lm_ps}, B * K, method=lm_model.init_state
            )
            init["lm_sum"] = jnp.zeros((B, K), jnp.float32)

        def step(carry, i):
            # ---- attention decoder step for all (B*K) beams ----
            tok_in = jnp.where(
                carry["last_tok"] < 0, sos_id, carry["last_tok"]
            ).reshape(B * K)
            if use_dec:
                dec_state, logits = model.apply(
                    {"params": params},
                    carry["dec_state"],
                    tok_in,
                    enc,
                    enc_proj,
                    enc_mask,
                    K,
                    loc_band,
                    method=model.decoder_step_beam,
                )
                att_logp = jax.nn.log_softmax(logits, axis=-1).reshape(
                    B, K, V)
            else:
                # ctc_beam: no decoder. att_logp contributes with weight
                # (1-w) == 0; zeros keep att_sum a pure liveness tracker
                # (0 for alive slots, NEG_INF for dead ones).
                att_logp = jnp.zeros((B, K, V))

            # ---- external LM step (shallow fusion) ----
            # The LM consumes the SAME token stream as the attention
            # decoder (sos first, then the chosen extension), so its
            # state reindexes by the same parent gather below.
            if use_lm:
                lm_state_new, lm_logits = lm_model.apply(
                    {"params": lm_ps}, carry["lm_state"], tok_in,
                    method=lm_model.step,
                )
                lm_total = carry["lm_sum"][..., None] + jax.nn.log_softmax(
                    lm_logits, axis=-1
                ).reshape(B, K, V)  # [B,K,V] accumulated LM scores

            # blank/sos/eos/unk never continue a hypothesis (eos is handled
            # by the finished buffer; unk is excluded from generation)
            bad = jnp.zeros((V,), bool).at[blank_id].set(True)
            bad = bad.at[sos_id].set(True).at[eos_id].set(True)
            bad = bad.at[unk_id].set(True)

            # ---- CTC prefix extension scores ----
            cand = None
            if use_partial and use_dec:
                # Pre-select the n_cand best continuation tokens per beam
                # by attention score; only those are CTC-scored.
                pre = jnp.where(bad[None, None, :], NEG_INF, att_logp)
                _, cand = jax.lax.top_k(pre, n_cand)  # [B,K,N]
            elif use_partial:
                cand = static_cand  # [B,K,N] CTC-posterior top-N
            if w > 0.0:
                psi, r_new, full_prob = _ctc_extension_scores(
                    ctc_logp, enc_len, carry["r"], carry["last_tok"],
                    carry["last_tok"] < 0, blank_id, cand=cand,
                )
            else:
                psi = jnp.zeros((B, K, V))
                r_new = None
                full_prob = jnp.zeros((B, K))

            att_total = carry["att_sum"][..., None] + att_logp  # [B,K,V]
            if use_partial:
                att_cont = jnp.take_along_axis(att_total, cand, axis=2)
                tok_bad = bad[cand]  # [B,K,N]
            else:
                att_cont = att_total
                tok_bad = jnp.broadcast_to(bad[None, None, :], (B, K, V))
            joint = (1.0 - w) * att_cont + w * psi  # [B,K,n_ext]
            if use_lm:
                lm_cont = (
                    jnp.take_along_axis(lm_total, cand, axis=2)
                    if use_partial else lm_total
                )
                joint = joint + lm_w * lm_cont

            # ---- eos candidates -> finished buffer (length-normalized) ----
            # Token insertion penalty: score(h) += penalty * |h|. All live
            # beams share length i at step i, so continuation ranking is
            # unaffected; only WHICH finalization wins (short vs long)
            # shifts — the reference family's beam knob.
            eos_score = ((1.0 - w) * att_total[..., eos_id] + w * full_prob
                         + penalty * carry["hyp_len"].astype(jnp.float32))
            if use_lm:
                eos_score = eos_score + lm_w * lm_total[..., eos_id]
            new_len = carry["hyp_len"] + 1  # includes eos
            if dc.length_norm:
                fin_cand_score = eos_score / new_len.astype(jnp.float32)
            else:
                fin_cand_score = eos_score
            # respect per-sample minlen; dead beams never finalize
            can_fin = (carry["hyp_len"] >= minlen[:, None]) & (
                carry["att_sum"] > NEG_INF / 2
            )
            fin_cand_score = jnp.where(can_fin, fin_cand_score, NEG_INF)
            # end-detect bookkeeping on RAW scores (the D margin is a
            # log-prob-sum quantity; normalized scores would never move
            # by D). Cheap [B]-sized math, computed unconditionally.
            mx_raw = jnp.max(
                jnp.where(can_fin, eos_score, NEG_INF), axis=1
            )  # [B]
            best_raw = jnp.maximum(carry["best_raw"], mx_raw)
            ended = (mx_raw < best_raw - ed_d) & (best_raw > NEG_INF / 2)
            end_cnt = jnp.where(ended, carry["end_cnt"] + 1, 0)
            # merge (K finished + K candidates) -> keep top K
            all_scores = jnp.concatenate(
                [carry["fin_score"], fin_cand_score], axis=1
            )  # [B,2K]
            all_tokens = jnp.concatenate(
                [carry["fin_tokens"], carry["tokens"]], axis=1
            )  # [B,2K,Lmax]
            all_len = jnp.concatenate(
                [carry["fin_len"], carry["hyp_len"]], axis=1
            )
            top_fin, fin_idx = jax.lax.top_k(all_scores, K)
            fin_tokens = jnp.take_along_axis(
                all_tokens, fin_idx[..., None], axis=1
            )
            fin_len = jnp.take_along_axis(all_len, fin_idx, axis=1)

            # ---- continuation candidates: mask specials + force-close ----
            cont = joint
            # Dead beam slots (only slot 0 is live at step 0) must be
            # suppressed explicitly: at ctc_weight == 1.0 the att_sum term
            # that used to carry their -inf has zero weight in `joint`.
            alive = carry["att_sum"] > NEG_INF / 2  # [B,K]
            cont = jnp.where(alive[..., None], cont, NEG_INF)
            cont = jnp.where(tok_bad, NEG_INF, cont)
            # beams of samples past maxlen cannot continue
            past = (i + 1 >= maxlen)[:, None, None]
            cont = jnp.where(past, NEG_INF, cont)
            if use_end_detect:
                # end-detected samples stop expanding; their beams die,
                # their finished buffer freezes, and the all-dead loop
                # predicate exits once every sample is done.
                cont = jnp.where(
                    (end_cnt >= ed_m)[:, None, None], NEG_INF, cont
                )
            # hypotheses may not exceed the static token buffer
            cont = jnp.where(
                (carry["hyp_len"] >= Lmax)[..., None], NEG_INF, cont
            )

            # ---- top-K over K*n_ext ----
            n_ext = cont.shape[-1]
            flat = cont.reshape(B, K * n_ext)
            top_scores, top_idx = jax.lax.top_k(flat, K)  # [B,K]
            parent = top_idx // n_ext
            if use_partial:
                token = jnp.take_along_axis(
                    cand.reshape(B, K * n_ext), top_idx, axis=1
                )
            else:
                token = top_idx % n_ext

            take = lambda x: jnp.take_along_axis(x, parent, axis=1)
            tokens = jnp.take_along_axis(
                carry["tokens"], parent[..., None], axis=1
            )
            hyp_len = take(carry["hyp_len"])
            tokens = jnp.where(
                (jnp.arange(Lmax)[None, None, :] == hyp_len[..., None])
                & (top_scores[..., None] > NEG_INF / 2),
                token[..., None],
                tokens,
            )
            hyp_len = hyp_len + (top_scores > NEG_INF / 2)
            att_sum = jnp.take_along_axis(
                att_cont.reshape(B, K * n_ext), top_idx, axis=1
            )
            att_sum = jnp.where(top_scores > NEG_INF / 2, att_sum, NEG_INF)

            if w > 0.0:
                # gather r for chosen (parent, token): [T,B,K,n_ext,2]
                r_flat = jnp.moveaxis(r_new, 0, 3).reshape(
                    B, K * n_ext, T, 2)
                r = jnp.take_along_axis(
                    r_flat, top_idx[..., None, None], axis=1
                )
            else:
                r = carry["r"]

            # gather decoder state for parents (flattened B*K indexing for
            # the cell state; beam-axis indexing for attention weights)
            flat_parent = (
                parent + jnp.arange(B)[:, None] * K
            ).reshape(B * K)
            if use_dec:
                new_dec_state = {
                    "h": dec_state["h"][:, flat_parent],
                    "c": dec_state["c"][:, flat_parent],
                    "att_w": jnp.take_along_axis(
                        dec_state["att_w"], parent[..., None], axis=1
                    ),
                    "context": dec_state["context"][flat_parent],
                }

            new_carry = {
                "tokens": tokens,
                "hyp_len": hyp_len,
                "att_sum": att_sum,
                "r": r,
                "last_tok": token,
                "fin_tokens": fin_tokens,
                "fin_len": fin_len,
                "fin_score": top_fin,
                "best_raw": best_raw,
                "end_cnt": end_cnt,
            }
            if use_dec:
                new_carry["dec_state"] = new_dec_state
            if use_lm:
                new_carry["lm_sum"] = jnp.take_along_axis(
                    lm_cont.reshape(B, K * n_ext), top_idx, axis=1
                )
                new_carry["lm_state"] = {
                    "h": lm_state_new["h"][:, flat_parent],
                    "c": lm_state_new["c"][:, flat_parent],
                }
            return new_carry, None

        # Early termination: beyond every sample's per-utterance maxlen all
        # continuations are -inf and finished-buffer updates are no-ops, so
        # stopping at max(maxlen) is exactly equivalent to running the full
        # static Lmax — but skips dead iterations when the bucket is padded
        # well past its members' audio lengths.
        max_steps = jnp.minimum(jnp.max(maxlen), Lmax)

        def cond_fn(carry_i):
            carry, i = carry_i
            # All-dead early exit (exactness-preserving): dead beams
            # produce only -inf continuations and never finalize, so the
            # carry is a fixpoint once every beam of every sample is dead.
            any_alive = jnp.any(carry["att_sum"] > NEG_INF / 2)
            return (i < max_steps) & any_alive

        def body_fn(carry_i):
            carry, i = carry_i
            carry, _ = step(carry, i)
            return (carry, i + 1)

        final, n_steps = jax.lax.while_loop(cond_fn, body_fn,
                                            (init, jnp.int32(0)))
        # Top-N finished hypotheses per sample, score-descending (argsort
        # is stable, so N=1 row 0 == the argmax 1-best).
        order = jnp.argsort(-final["fin_score"], axis=1)[:, :n_best]
        nb_tokens = jnp.take_along_axis(
            final["fin_tokens"], order[:, :, None], axis=1
        )  # [B,N,Lmax]
        nb_len = jnp.take_along_axis(final["fin_len"], order, axis=1)
        nb_score = jnp.take_along_axis(final["fin_score"], order, axis=1)
        # Executed loop-step count, broadcast per sample so it shards
        # cleanly under DP (shards may exit at different steps).
        steps = jnp.full((B,), n_steps, jnp.int32)
        return nb_tokens, nb_len, nb_score, steps

    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        from gluon_e2e_asr.parallel.mesh import DATA_AXIS

        d = P(DATA_AXIS)
        # check_vma=False as in the train step: scan/while carries start
        # unvarying and become data-varying on step one.
        device_fn = jax.shard_map(
            device_fn, mesh=mesh,
            in_specs=(P(), P(), d, d), out_specs=(d, d, d, d),
            check_vma=False,
        )
    device_fn = jax.jit(device_fn)
    # Empty pytree when fusion is off: one signature either way (and the
    # jitted fn never traces LM code at lm_weight == 0).
    lm_arg = lm_params if use_lm else ()

    def decode(params, audio, audio_len):
        tokens, lens, scores, steps = device_fn(params, lm_arg, audio,
                                                audio_len)
        tokens = np.asarray(tokens)
        lens = np.asarray(lens)
        decode.last_steps = int(np.max(np.asarray(steps)))
        texts = [
            tokenizer.decode(tokens[b, 0, : int(lens[b, 0])])
            for b in range(tokens.shape[0])
        ]
        return texts, np.asarray(scores)[:, 0]

    def decode_nbest(params, audio, audio_len):
        """[[(text, score)] * N] per utterance, score-descending. Slots
        beyond the number of finished hypotheses carry the NEG_INF
        sentinel (-1e30; filter with ``score > NEG_INF / 2``)."""
        tokens, lens, scores, steps = device_fn(params, lm_arg, audio,
                                                audio_len)
        tokens, lens = np.asarray(tokens), np.asarray(lens)
        decode.last_steps = int(np.max(np.asarray(steps)))
        scores = np.asarray(scores)
        return [
            [
                (tokenizer.decode(tokens[b, n, : int(lens[b, n])]),
                 float(scores[b, n]))
                for n in range(tokens.shape[1])
            ]
            for b in range(tokens.shape[0])
        ]

    decode.nbest = decode_nbest
    return decode
