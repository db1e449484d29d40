"""Beam search unit tests [SURVEY.md §4 'Unit: beam search'].

The CTC prefix recursion is validated against the (already
brute-force-validated) CTC forward algorithm through the identity
  logaddexp(r_n(h)[T-1], r_b(h)[T-1]) == log P_ctc(h)  == -ctc_loss(h),
checked after every extension step; plus degenerate-case equivalences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import Config, DataConfig, DecodeConfig, LossConfig, ModelConfig, TrainConfig
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.decoding.beam import (
    NEG_INF,
    _ctc_extension_scores,
    _logaddexp,
    make_beam_decoder,
)
from gluon_e2e_asr.ops.ctc import ctc_forward_alpha


def _rand_logp(B, T, V, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, V).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def _full_prob_reference(logp, T_len, seq):
    """log P_ctc(seq) via the validated forward algorithm."""
    L = max(len(seq), 1)
    labels = np.zeros((1, L), np.int32)
    labels[0, : len(seq)] = seq
    nll = ctc_forward_alpha(
        jnp.asarray(logp[None]),
        jnp.array([T_len], jnp.int32),
        jnp.asarray(labels),
        jnp.array([len(seq)], jnp.int32),
    )
    return -float(nll[0])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("T_len", [6, 4])
def test_prefix_recursion_matches_forward_algorithm(seed, T_len):
    """Extend prefixes token by token; after each extension the full-prob
    derived from the r pair must equal the CTC forward likelihood."""
    T, V, K = 6, 5, 1
    logp = _rand_logp(1, T, V, seed)[0]
    enc_len = jnp.array([T_len], jnp.int32)
    ctc_logp = jnp.asarray(logp[None])

    # start: empty prefix
    xb_cum = np.cumsum(logp[:, 0])
    r = np.stack([np.full(T, NEG_INF, np.float32), xb_cum], axis=-1)
    r = jnp.asarray(r[None, None])  # [1,1,T,2]
    last = jnp.array([[-1]], jnp.int32)

    seq = []
    for tok in [1, 2, 2, 3]:
        psi, r_new, full_prob = _ctc_extension_scores(
            ctc_logp, enc_len, r, last, last < 0, blank_id=0
        )
        # full prob of the *current* prefix (before extension)
        want_cur = _full_prob_reference(logp, T_len, seq)
        np.testing.assert_allclose(float(full_prob[0, 0]), want_cur,
                                   rtol=1e-4, atol=1e-4)
        # extend by tok: r_new[:, b, k, v, :] at v=tok becomes r of h
        r = jnp.moveaxis(r_new, 0, 2)[:, :, :, tok, :]  # [1,1,T,2]
        seq.append(tok)
        last = jnp.array([[tok]], jnp.int32)
        # full prob of h from the freshly gathered r at the last valid frame
        r_end = np.asarray(r[0, 0, T_len - 1])
        got_h = float(_logaddexp(jnp.asarray(r_end[0]), jnp.asarray(r_end[1])))
        want_h = _full_prob_reference(logp, T_len, seq)
        np.testing.assert_allclose(got_h, want_h, rtol=1e-4, atol=1e-4)
        # psi (prefix score) upper-bounds the exact sequence probability
        assert float(psi[0, 0, tok]) >= want_h - 1e-4


def test_prefix_scores_sane_distribution():
    """psi over single-token extensions of the empty prefix equals the
    CTC prefix probability: P(output starts with c). Sum over c of
    exp(psi) + P(empty) must be ~1 when T covers everything."""
    T, V = 5, 4
    logp = _rand_logp(1, T, V, seed=3)[0]
    ctc_logp = jnp.asarray(logp[None])
    enc_len = jnp.array([T], jnp.int32)
    xb_cum = np.cumsum(logp[:, 0])
    r = jnp.asarray(
        np.stack([np.full(T, NEG_INF, np.float32), xb_cum], -1)[None, None]
    )
    last = jnp.array([[-1]], jnp.int32)
    psi, _, full_prob = _ctc_extension_scores(
        ctc_logp, enc_len, r, last, last < 0, blank_id=0
    )
    p_starts = np.exp(np.asarray(psi[0, 0, 1:]))  # skip blank column
    p_empty = np.exp(_full_prob_reference(logp, T, []))
    np.testing.assert_allclose(p_starts.sum() + p_empty, 1.0, rtol=1e-4)


def _tiny_model_setup(seed=0):
    from gluon_e2e_asr.models.asr import build_model

    cfg = Config(
        model=ModelConfig(enc_hidden=24, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=24, dec_embed=12, att_dim=12,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.3),
        decode=DecodeConfig(method="beam", beam_size=4, ctc_weight=0.3,
                            maxlen_ratio=0.6, length_norm=True),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    rng = np.random.RandomState(seed)
    audio = rng.randn(2, 8000).astype(np.float32) * 0.1
    audio_len = np.array([8000, 6000], np.int32)
    # init params
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer,
    )

    batch = {
        "audio": audio, "audio_len": audio_len,
        "labels": rng.randint(4, 10, (2, 6)).astype(np.int32),
        "label_len": np.array([6, 4], np.int32),
    }
    state = create_train_state(cfg, model, make_optimizer(cfg), batch)
    return cfg, tok, model, state, audio, audio_len


@pytest.mark.slow
def test_beam_decoder_runs_and_is_valid():
    cfg, tok, model, state, audio, audio_len = _tiny_model_setup()
    decode = make_beam_decoder(model, cfg, tok)
    texts, scores = decode(state.params, jnp.asarray(audio),
                           jnp.asarray(audio_len))
    assert len(texts) == 2
    assert np.isfinite(scores).all()
    for t in texts:
        assert all(ch in tok.alphabet for ch in t), t


def test_beam_k1_att_only_matches_greedy_att():
    """beam(K=1, ctc_weight=0, no length norm) == stepwise argmax attention
    decoding [SURVEY.md §4 degenerate check]."""
    cfg, tok, model, state, audio, audio_len = _tiny_model_setup(seed=4)
    cfg.decode.beam_size = 1
    cfg.decode.ctc_weight = 0.0
    cfg.decode.length_norm = False
    decode = make_beam_decoder(model, cfg, tok)
    texts, _ = decode(state.params, jnp.asarray(audio), jnp.asarray(audio_len))

    # reference: greedy attention decode via decoder_step
    from gluon_e2e_asr.frontend.features import frontend_apply

    feats, feat_len = frontend_apply(cfg.frontend, jnp.asarray(audio),
                                     jnp.asarray(audio_len), train=False)
    enc, enc_len, _ = model.apply({"params": state.params}, feats, feat_len,
                                  method=model.encode)
    B, T = enc.shape[0], enc.shape[1]
    enc_mask = (jnp.arange(T)[None] < enc_len[:, None]).astype(jnp.float32)
    enc_proj = model.apply({"params": state.params}, enc,
                           method=model.decoder_precompute)
    dstate = model.apply({"params": state.params}, B, T,
                         method=model.decoder_init_state)
    maxlen = np.maximum(
        (cfg.decode.maxlen_ratio * np.asarray(enc_len)).astype(int), 1
    )
    # Follow the argmax continuation path (what beam K=1 explores) and, at
    # every step, record the finalized candidate prefix+eos with its total
    # att logp — beam K=1 returns the best finalized candidate.
    tokens = np.full((B,), tok.sos_id, np.int64)
    att_sum = np.zeros(B)
    prefix = [[] for _ in range(B)]
    best_score = np.full(B, -np.inf)
    best_hyp = [[] for _ in range(B)]
    for i in range(int(maxlen.max())):
        dstate, logits = model.apply(
            {"params": state.params}, dstate, jnp.asarray(tokens, jnp.int32),
            enc, enc_proj, enc_mask, method=model.decoder_step,
        )
        lp = np.array(jax.nn.log_softmax(logits, -1))
        for b in range(B):
            if i >= maxlen[b]:
                continue
            fin = att_sum[b] + lp[b, tok.eos_id]
            if fin > best_score[b]:
                best_score[b] = fin
                best_hyp[b] = list(prefix[b])
        # disallow blank/sos/eos/unk for continuation, like the beam
        lp[:, [tok.blank_id, tok.sos_id, tok.eos_id, tok.unk_id]] = -1e30
        nxt = lp.argmax(-1)
        for b in range(B):
            if i < maxlen[b]:
                prefix[b].append(int(nxt[b]))
                att_sum[b] += lp[b, nxt[b]]
        tokens = nxt
    greedy_texts = [tok.decode(h) for h in best_hyp]
    assert texts == greedy_texts, (texts, greedy_texts)


@pytest.mark.slow
def test_beam_full_width_matches_exhaustive_search():
    """With K >= the number of finalizable hypotheses, w=0 and no length
    norm, the beam must return exactly the brute-force argmax over every
    sequence of length <= maxlen-1 (incl. the empty one) — end-to-end
    validation of the finished-buffer merge, force-close, and eos
    scoring [SURVEY.md §4 'Unit: beam search']."""
    cfg, tok, model, state, audio, audio_len = _tiny_model_setup(seed=9)
    audio, audio_len = audio[:1], audio_len[:1]  # B=1

    from gluon_e2e_asr.frontend.features import frontend_apply

    feats, feat_len = frontend_apply(cfg.frontend, jnp.asarray(audio),
                                     jnp.asarray(audio_len), train=False)
    enc, enc_len, _ = model.apply({"params": state.params}, feats, feat_len,
                                  method=model.encode)
    T = enc.shape[1]
    maxlen = 3  # sequences of length 0..2 are finalizable
    cfg.decode.maxlen_ratio = maxlen / float(enc_len[0])
    cfg.decode.ctc_weight = 0.0
    cfg.decode.length_norm = False

    allowed = [i for i in range(tok.vocab_size)
               if i not in (tok.blank_id, tok.sos_id, tok.eos_id, tok.unk_id)]
    A = len(allowed)
    cfg.decode.beam_size = 1 + A + A * A  # every hypothesis survives

    # ---- brute force via the plain decoder_step (shared-enc parity with
    # decoder_step_beam is asserted in test_beam_shared_enc) ----
    def step(dstate, tokens, n):
        e = jnp.broadcast_to(enc, (n,) + enc.shape[1:])
        em = (jnp.arange(T)[None] < enc_len[:1, None]).astype(jnp.float32)
        em = jnp.broadcast_to(em, (n, T))
        ep = model.apply({"params": state.params}, e,
                         method=model.decoder_precompute)
        dstate, logits = model.apply(
            {"params": state.params}, dstate, jnp.asarray(tokens, jnp.int32),
            e, ep, em, method=model.decoder_step)
        return dstate, np.asarray(jax.nn.log_softmax(logits, -1))

    def tile(d, k):  # h/c are [layers, B, H]; att_w/context lead with B
        return {
            "h": jnp.repeat(d["h"], k, axis=1),
            "c": jnp.repeat(d["c"], k, axis=1),
            "att_w": jnp.repeat(d["att_w"], k, axis=0),
            "context": jnp.repeat(d["context"], k, axis=0),
        }

    st0 = model.apply({"params": state.params}, 1, T,
                      method=model.decoder_init_state)
    st1, lp0 = step(st0, [tok.sos_id], 1)                  # after sos
    st2, lp1 = step(tile(st1, A), allowed, A)              # after (c)
    _, lp2 = step(tile(st2, A), allowed * A, A * A)        # after (c,d)

    best_score, best_seq = float(lp0[0, tok.eos_id]), []   # empty hyp
    for ci, c in enumerate(allowed):
        s1 = lp0[0, c] + lp1[ci, tok.eos_id]
        if s1 > best_score:
            best_score, best_seq = float(s1), [c]
        for di, d in enumerate(allowed):
            s2 = lp0[0, c] + lp1[ci, d] + lp2[ci * A + di, tok.eos_id]
            if s2 > best_score:
                best_score, best_seq = float(s2), [c, d]

    decode = make_beam_decoder(model, cfg, tok)
    texts, scores = decode(state.params, jnp.asarray(audio),
                           jnp.asarray(audio_len))
    assert texts[0] == tok.decode(best_seq), (texts, best_seq)
    np.testing.assert_allclose(scores[0], best_score, atol=1e-4)


@pytest.mark.slow
def test_beam_full_width_joint_matches_exhaustive_search():
    """Same exhaustive check with ctc_weight>0: the winning hypothesis
    must maximize (1-w)*att_logp + w*log P_ctc(seq), with the CTC term
    from the validated forward algorithm — integration check of the
    per-step r-state gathers feeding the eos full-probability."""
    # Small alphabet: the hypothesis count (and so the required beam
    # width) shrinks quadratically, keeping the full-vocab CTC scoring
    # at K=73 instead of K=813.
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer,
    )

    cfg = Config(
        model=ModelConfig(enc_hidden=24, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=24, dec_embed=12, att_dim=12,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.3),
        decode=DecodeConfig(method="beam"),
    )
    tok = CharTokenizer("abcdefgh")
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    rng = np.random.RandomState(11)
    audio = rng.randn(1, 4000).astype(np.float32) * 0.1
    audio_len = np.array([4000], np.int32)
    state = create_train_state(cfg, model, make_optimizer(cfg), {
        "audio": audio, "audio_len": audio_len,
        "labels": rng.randint(4, 10, (1, 6)).astype(np.int32),
        "label_len": np.array([6], np.int32),
    })

    from gluon_e2e_asr.frontend.features import frontend_apply

    feats, feat_len = frontend_apply(cfg.frontend, jnp.asarray(audio),
                                     jnp.asarray(audio_len), train=False)
    enc, enc_len, ctc_logits = model.apply(
        {"params": state.params}, feats, feat_len, method=model.encode)
    T = enc.shape[1]
    T_len = int(enc_len[0])
    ctc_logp = np.asarray(jax.nn.log_softmax(ctc_logits, -1))[0]

    maxlen = 3
    w = 0.5
    cfg.decode.maxlen_ratio = maxlen / float(T_len)
    cfg.decode.ctc_weight = w
    cfg.decode.length_norm = False

    allowed = [i for i in range(tok.vocab_size)
               if i not in (tok.blank_id, tok.sos_id, tok.eos_id, tok.unk_id)]
    A = len(allowed)
    cfg.decode.beam_size = 1 + A + A * A

    def step(dstate, tokens, n):
        e = jnp.broadcast_to(enc, (n,) + enc.shape[1:])
        em = (jnp.arange(T)[None] < enc_len[:1, None]).astype(jnp.float32)
        em = jnp.broadcast_to(em, (n, T))
        ep = model.apply({"params": state.params}, e,
                         method=model.decoder_precompute)
        dstate, logits = model.apply(
            {"params": state.params}, dstate, jnp.asarray(tokens, jnp.int32),
            e, ep, em, method=model.decoder_step)
        return dstate, np.asarray(jax.nn.log_softmax(logits, -1))

    def tile(d, k):
        return {
            "h": jnp.repeat(d["h"], k, axis=1),
            "c": jnp.repeat(d["c"], k, axis=1),
            "att_w": jnp.repeat(d["att_w"], k, axis=0),
            "context": jnp.repeat(d["context"], k, axis=0),
        }

    st0 = model.apply({"params": state.params}, 1, T,
                      method=model.decoder_init_state)
    st1, lp0 = step(st0, [tok.sos_id], 1)
    st2, lp1 = step(tile(st1, A), allowed, A)
    _, lp2 = step(tile(st2, A), allowed * A, A * A)

    def joint(att_with_eos, seq):
        return ((1.0 - w) * att_with_eos
                + w * _full_prob_reference(ctc_logp, T_len, seq))

    best_score = joint(float(lp0[0, tok.eos_id]), [])
    best_seq = []
    for ci, c in enumerate(allowed):
        s1 = joint(float(lp0[0, c] + lp1[ci, tok.eos_id]), [c])
        if s1 > best_score:
            best_score, best_seq = s1, [c]
        for di, d in enumerate(allowed):
            s2 = joint(
                float(lp0[0, c] + lp1[ci, d] + lp2[ci * A + di, tok.eos_id]),
                [c, d])
            if s2 > best_score:
                best_score, best_seq = s2, [c, d]

    decode = make_beam_decoder(model, cfg, tok)
    texts, scores = decode(state.params, jnp.asarray(audio),
                           jnp.asarray(audio_len))
    assert texts[0] == tok.decode(best_seq), (texts, best_seq)
    np.testing.assert_allclose(scores[0], best_score, atol=1e-3)


def test_insertion_penalty_lengthens_hypotheses():
    """decode.penalty with length_norm OFF (its effective regime — under
    length normalization the penalty term divides down to a near-constant
    offset and the decoder warns): 0 must reproduce the default decode
    exactly; a strongly positive penalty must not shorten any hypothesis
    (and a strongly negative one must not lengthen any), with a strict
    aggregate length change between the two extremes."""
    cfg, tok, model, state, audio, audio_len = _tiny_model_setup(seed=6)
    cfg.decode.beam_size = 4
    cfg.decode.length_norm = False
    base = make_beam_decoder(model, cfg, tok)
    t0, s0 = base(state.params, jnp.asarray(audio), jnp.asarray(audio_len))

    cfg.decode.penalty = 0.0
    same = make_beam_decoder(model, cfg, tok)
    t1, s1 = same(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    assert t0 == t1
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))

    cfg.decode.penalty = 5.0
    longer = make_beam_decoder(model, cfg, tok)
    tl, _ = longer(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    assert all(len(a) >= len(b) for a, b in zip(tl, t0)), (tl, t0)

    cfg.decode.penalty = -5.0
    shorter = make_beam_decoder(model, cfg, tok)
    ts, _ = shorter(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    assert all(len(a) <= len(b) for a, b in zip(ts, t0)), (ts, t0)
    # The knob must actually bite: at -5 every hypothesis collapses
    # toward empty, at +5 it pads out — the totals must differ unless
    # the base decode was already all-empty.
    if any(t0):
        assert sum(map(len, ts)) < sum(map(len, tl)), (ts, tl)


def test_end_detect_off_margin_is_exact():
    """decode.end_detect with an unreachable margin must reproduce the
    exact search bit-for-bit (plumbing does not perturb the carry), and
    an always-firing margin must cut the executed loop steps while still
    returning a finished hypothesis per sample."""
    cfg, tok, model, state, audio, audio_len = _tiny_model_setup(seed=7)
    base = make_beam_decoder(model, cfg, tok)
    t0, s0 = base(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    steps_off = base.last_steps

    cfg.decode.end_detect = True
    cfg.decode.end_detect_d = 1e9  # mx < best - 1e9 never holds
    exact = make_beam_decoder(model, cfg, tok)
    t1, s1 = exact(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    assert t0 == t1
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
    assert exact.last_steps == steps_off

    cfg.decode.end_detect_d = -1e9  # fires m steps after first finish
    cfg.decode.end_detect_m = 2
    eager = make_beam_decoder(model, cfg, tok)
    t2, s2 = eager(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    assert eager.last_steps < steps_off
    assert all(s > NEG_INF / 2 for s in np.asarray(s2)), s2


@pytest.mark.slow
def test_end_detect_default_margin_on_trained_model():
    """On an overfit model the default D=10/M=3 end detection must keep
    the 1-best outputs identical while executing FEWER loop steps than
    the exact search (a confident model's endings leave nothing within
    the margin afterwards)."""
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    cfg = Config(
        model=ModelConfig(enc_hidden=32, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=32, dec_embed=16, att_dim=16,
                          att_type="dot"),
        loss=LossConfig(mtl_alpha=0.3, label_smoothing=0.0),
        train=TrainConfig(learning_rate=2e-3, warmup_steps=20),
        decode=DecodeConfig(method="beam", beam_size=4, ctc_weight=0.3,
                            maxlen_ratio=0.8),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    rng = np.random.RandomState(3)
    audio = (rng.randn(4, 8000) * 0.1).astype(np.float32)
    audio_len = np.array([8000, 8000, 7000, 6000], np.int32)
    labels = rng.randint(4, 10, (4, 5)).astype(np.int32)
    batch = {
        "audio": audio, "audio_len": audio_len,
        "labels": labels, "label_len": np.array([5, 5, 4, 4], np.int32),
    }
    state = create_train_state(cfg, model, make_optimizer(cfg), batch)
    step = make_train_step(model, cfg, make_optimizer(cfg), None, None)
    for _ in range(300):  # overfit the 4-utt batch
        state, metrics = step(state, batch)
    assert float(metrics["loss"]) < 0.5, metrics

    base = make_beam_decoder(model, cfg, tok)
    t0, _ = base(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    cfg.decode.end_detect = True
    ed = make_beam_decoder(model, cfg, tok)
    t1, _ = ed(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    assert t0 == t1
    assert ed.last_steps < base.last_steps, (ed.last_steps, base.last_steps)


def test_nbest_ordering_and_1best_consistency():
    """decode.nbest returns score-descending lists whose head equals the
    1-best path; finite entries are distinct hypotheses."""
    cfg, tok, model, state, audio, audio_len = _tiny_model_setup(seed=5)
    cfg.decode.beam_size = 4
    cfg.decode.nbest = 4
    decode = make_beam_decoder(model, cfg, tok)
    texts, scores = decode(state.params, jnp.asarray(audio),
                           jnp.asarray(audio_len))
    nbest = decode.nbest(state.params, jnp.asarray(audio),
                         jnp.asarray(audio_len))
    for b in range(len(texts)):
        entries = nbest[b]
        assert entries[0][0] == texts[b]
        np.testing.assert_allclose(entries[0][1], scores[b], rtol=1e-6)
        finite = [s for _, s in entries if np.isfinite(s) and s > NEG_INF / 2]
        assert finite == sorted(finite, reverse=True)


# ---------------------------------------------------------------------------
# Partial (candidate-restricted) CTC prefix scoring [VERDICT.md weak #6]
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_partial_scoring_matches_full_when_candidates_cover_vocab():
    """With ctc_score_candidates >= every usable token, partial scoring
    restricts nothing, so hypotheses and scores must match full-vocab
    scoring exactly."""
    cfg, tok, model, state, audio, audio_len = _tiny_model_setup(seed=2)
    decode_full = make_beam_decoder(model, cfg, tok)
    texts_f, scores_f = decode_full(state.params, jnp.asarray(audio),
                                    jnp.asarray(audio_len))
    cfg.decode.ctc_score_candidates = tok.vocab_size - 4  # all non-special
    decode_part = make_beam_decoder(model, cfg, tok)
    texts_p, scores_p = decode_part(state.params, jnp.asarray(audio),
                                    jnp.asarray(audio_len))
    assert texts_f == texts_p
    np.testing.assert_allclose(scores_f, scores_p, rtol=1e-5, atol=1e-5)


class _BigVocabTok:
    """Tokenizer stand-in with a BPE-sized vocabulary."""

    def __init__(self, vocab_size=1000):
        self._v = vocab_size

    blank_id, unk_id, sos_id, eos_id = 0, 1, 2, 3

    @property
    def vocab_size(self):
        return self._v

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def _big_vocab_setup(n_cand):
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer,
    )

    tok = _BigVocabTok(1000)
    cfg = Config(
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(4,),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.3),
        decode=DecodeConfig(method="beam", beam_size=4, ctc_weight=0.3,
                            maxlen_ratio=0.3, length_norm=True,
                            ctc_score_candidates=n_cand),
    )
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    rng = np.random.RandomState(0)
    audio = rng.randn(2, 4000).astype(np.float32) * 0.1
    audio_len = np.array([4000, 3200], np.int32)
    batch = {
        "audio": audio, "audio_len": audio_len,
        "labels": rng.randint(4, 999, (2, 5)).astype(np.int32),
        "label_len": np.array([5, 4], np.int32),
    }
    state = create_train_state(cfg, model, make_optimizer(cfg), batch)
    return cfg, tok, model, state, audio, audio_len


@pytest.mark.slow
def test_partial_scoring_handles_bpe_sized_vocab():
    """V=1000 decodes through the candidate-restricted prefix state
    [T,B,K,N,2] without materializing the [T,B,K,V,2] full state."""
    cfg, tok, model, state, audio, audio_len = _big_vocab_setup(n_cand=8)
    decode = make_beam_decoder(model, cfg, tok)
    texts, scores = decode(state.params, jnp.asarray(audio),
                           jnp.asarray(audio_len))
    assert len(texts) == 2
    assert np.isfinite(scores).all()


def test_full_vocab_scoring_refuses_large_vocab():
    """Full-vocab prefix scoring at V=1000 must fail loudly, not OOM."""
    cfg, tok, model, state, audio, audio_len = _big_vocab_setup(n_cand=0)
    with pytest.raises(ValueError, match="ctc_score_candidates"):
        make_beam_decoder(model, cfg, tok)


def test_partial_candidates_below_beam_refused():
    cfg, tok, model, state, audio, audio_len = _big_vocab_setup(n_cand=2)
    with pytest.raises(ValueError, match="beam_size"):
        make_beam_decoder(model, cfg, tok)
