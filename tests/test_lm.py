"""External-LM shallow fusion tests [SURVEY.md §2.1 #17 "canonical
Watanabe-style hybrid decoding"; SURVEY.md §4 test strategy].

Covers: step-vs-scan parity of the LSTM LM, trainability (perplexity
drops when overfitting), checkpoint round-trip + vocab guard, the
lm_weight=0 bit-identity contract, and full-width exhaustive-search
optimality of the fused beam score att + lm_weight * lm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import (
    Config, DecodeConfig, LossConfig, ModelConfig,
)
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.decoding.beam import make_beam_decoder
from gluon_e2e_asr.models.lm import (
    LSTMLM, lm_logprob, lm_logprob_batch, load_lm, save_lm,
)


def _tiny_lm(vocab_size, layers=2, seed=0):
    model = LSTMLM(vocab_size=vocab_size, embed_dim=16, hidden=24,
                   layers=layers)
    params = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2), jnp.int32),
        jnp.ones((1,), jnp.int32),
    )["params"]
    return model, params


@pytest.mark.parametrize("layers", [1, 2])
def test_lm_step_matches_scan(layers):
    """Stepping token by token must reproduce the teacher-forced scan's
    per-position logits exactly (same (h, c) recursion, two code paths
    — the beam uses step, training uses __call__)."""
    tok = CharTokenizer()
    model, params = _tiny_lm(tok.vocab_size, layers=layers)
    rng = np.random.RandomState(0)
    B, L = 3, 7
    tokens_in = rng.randint(0, tok.vocab_size, (B, L)).astype(np.int32)
    lens = np.array([L, L - 2, 4], np.int32)

    full = model.apply({"params": params}, jnp.asarray(tokens_in),
                       jnp.asarray(lens))  # [B, L, V]

    state = model.apply({"params": params}, B, method=model.init_state)
    for i in range(L):
        state, logits = model.apply(
            {"params": params}, state, jnp.asarray(tokens_in[:, i]),
            method=model.step,
        )
        for b in range(B):
            if i < lens[b]:
                np.testing.assert_allclose(
                    np.asarray(logits[b]), np.asarray(full[b, i]),
                    rtol=1e-5, atol=1e-5,
                )


def test_lm_logprob_matches_manual_sum():
    tok = CharTokenizer()
    model, params = _tiny_lm(tok.vocab_size)
    ids = tok.encode("abc a")
    got = lm_logprob(model, params, np.array(ids), tok.eos_id, tok.sos_id)

    # manual: step through sos + ids, sum logp of (ids + eos)
    state = model.apply({"params": params}, 1, method=model.init_state)
    want = 0.0
    stream = [tok.sos_id] + ids
    targets = ids + [tok.eos_id]
    for t_in, t_out in zip(stream, targets):
        state, logits = model.apply(
            {"params": params}, state, jnp.asarray([t_in], jnp.int32),
            method=model.step,
        )
        want += float(jax.nn.log_softmax(logits, -1)[0, t_out])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lm_logprob_batch_matches_per_row():
    """The padded batched scorer (one jitted call, used by the n-best
    rescoring tool) must agree with the per-row exact scorer on rows of
    different lengths, including the empty row."""
    tok = CharTokenizer()
    model, params = _tiny_lm(tok.vocab_size)
    rows = [tok.encode("abc a"), tok.encode("z"), [], tok.encode("hello ab")]
    got = lm_logprob_batch(model, params, rows, tok.eos_id, tok.sos_id)
    for row, g in zip(rows, got):
        want = lm_logprob(model, params, np.array(row, np.int32),
                          tok.eos_id, tok.sos_id)
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)


def test_lm_overfit_reduces_perplexity(tmp_path):
    """A tiny LM trained on a 4-sentence corpus must overfit: dev ppl
    (same sentences) far below the uniform-vocab baseline."""
    from gluon_e2e_asr.train_lm import train_lm

    cfg = Config()
    cfg.data.synth_num_train = 4
    cfg.data.synth_num_dev = 4
    cfg.data.synth_seed = 7
    cfg.lm.embed_dim = 32
    cfg.lm.hidden = 64
    cfg.lm.layers = 1
    cfg.lm.max_len = 48
    cfg.lm.batch_size = 4
    cfg.lm.num_epochs = 150
    cfg.lm.warmup_steps = 10
    cfg.lm.learning_rate = 3e-3
    # dev == train sentences: regenerate the same synthetic manifest
    cfg.data.synth_seed = 7

    # Overfit check wants dev == train; synthetic dev uses seed+1, so
    # instead train on extra_text = the dev transcripts.
    from gluon_e2e_asr.train_lm import gather_texts

    _, _, dev_texts = gather_texts(cfg)
    extra = tmp_path / "text.txt"
    extra.write_text("\n".join(dev_texts) + "\n")
    cfg.data.synth_num_train = 0
    cfg.lm.extra_text = str(extra)

    res = train_lm(cfg, workdir=str(tmp_path))
    tok = CharTokenizer()
    assert res["best_dev_ppl"] < tok.vocab_size / 4  # far below uniform
    assert os.path.exists(res["ckpt"])
    assert os.path.exists(res["ckpt"] + ".json")


def test_lm_ckpt_roundtrip_and_vocab_guard(tmp_path):
    tok = CharTokenizer()
    model, params = _tiny_lm(tok.vocab_size)
    path = str(tmp_path / "lm.msgpack")
    save_lm(path, params, {
        "vocab_size": tok.vocab_size, "embed_dim": 16, "hidden": 24,
        "layers": 2, "vocab": tok.to_json(),
    })
    model2, params2, meta = load_lm(path)
    ids = tok.encode("ab c")
    lp1 = lm_logprob(model, params, np.array(ids), tok.eos_id, tok.sos_id)
    lp2 = lm_logprob(model2, params2, np.array(ids), tok.eos_id, tok.sos_id)
    np.testing.assert_allclose(lp1, lp2, rtol=1e-6, atol=1e-6)

    # vocab-size guard at fusion time
    cfg = Config(
        model=ModelConfig(enc_hidden=24, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=24, dec_embed=12, att_dim=12,
                          att_type="add"),
        decode=DecodeConfig(method="beam", beam_size=2, lm_weight=0.3,
                            lm_ckpt=path),
    )
    small_tok = CharTokenizer("abc")
    from gluon_e2e_asr.models.asr import build_model

    am = build_model(cfg, small_tok.vocab_size, small_tok.sos_id,
                     small_tok.eos_id)
    with pytest.raises(ValueError, match="vocab_size"):
        make_beam_decoder(am, cfg, small_tok)


def _tiny_am(tok, seed=3, att_type="add"):
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer,
    )

    cfg = Config(
        model=ModelConfig(enc_hidden=24, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=24, dec_embed=12, att_dim=12,
                          att_type=att_type),
        loss=LossConfig(mtl_alpha=0.3),
        decode=DecodeConfig(method="beam"),
    )
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    rng = np.random.RandomState(seed)
    audio = rng.randn(1, 4000).astype(np.float32) * 0.1
    audio_len = np.array([4000], np.int32)
    state = create_train_state(cfg, model, make_optimizer(cfg), {
        "audio": audio, "audio_len": audio_len,
        "labels": rng.randint(4, 10, (1, 6)).astype(np.int32),
        "label_len": np.array([6], np.int32),
    })
    return cfg, model, state, audio, audio_len


def test_beam_lm_weight_zero_matches_no_lm_bitwise():
    """lm_weight=0 must leave the beam bit-identical to a decoder that
    never saw an LM (the contract that lets fusion ship enabled-by-ckpt
    but off-by-default)."""
    tok = CharTokenizer()
    cfg, model, state, audio, audio_len = _tiny_am(tok)
    cfg.decode.beam_size = 4
    lm, lm_params = _tiny_lm(tok.vocab_size)

    base = make_beam_decoder(model, cfg, tok)
    t0, s0 = base(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    cfg.decode.lm_weight = 0.0
    fused = make_beam_decoder(model, cfg, tok, lm_bundle=(lm, lm_params))
    t1, s1 = fused(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    assert t0 == t1
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))


@pytest.mark.slow
def test_beam_full_width_lm_fusion_matches_exhaustive_search():
    """With full beam width, ctc_weight=0, no length norm and an LM at
    lm_weight=0.4, the beam's winner must be the brute-force argmax of
    att_logp(seq, eos) + 0.4 * log p_lm(seq, eos) over every sequence of
    length <= 2 — end-to-end validation that the LM term accumulates,
    reindexes with parents, and enters eos finalization correctly."""
    tok = CharTokenizer("abcdef")
    cfg, model, state, audio, audio_len = _tiny_am(tok, seed=5)
    lm, lm_params = _tiny_lm(tok.vocab_size, seed=9)

    from gluon_e2e_asr.frontend.features import frontend_apply

    feats, feat_len = frontend_apply(cfg.frontend, jnp.asarray(audio),
                                     jnp.asarray(audio_len), train=False)
    enc, enc_len, _ = model.apply({"params": state.params}, feats, feat_len,
                                  method=model.encode)
    T = enc.shape[1]
    maxlen = 3
    lm_w = 0.4
    cfg.decode.maxlen_ratio = maxlen / float(enc_len[0])
    cfg.decode.ctc_weight = 0.0
    cfg.decode.length_norm = False
    cfg.decode.lm_weight = lm_w

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

    def score(att_with_eos, seq):
        return att_with_eos + lm_w * lm_logprob(
            lm, lm_params, np.array(seq, np.int32), tok.eos_id, tok.sos_id)

    best_score = score(float(lp0[0, tok.eos_id]), [])
    best_seq = []
    for ci, c in enumerate(allowed):
        s1 = score(float(lp0[0, c] + lp1[ci, tok.eos_id]), [c])
        if s1 > best_score:
            best_score, best_seq = s1, [c]
        for di, d in enumerate(allowed):
            s2 = score(
                float(lp0[0, c] + lp1[ci, d] + lp2[ci * A + di, tok.eos_id]),
                [c, d])
            if s2 > best_score:
                best_score, best_seq = s2, [c, d]

    decode = make_beam_decoder(model, cfg, tok, lm_bundle=(lm, lm_params))
    texts, scores = decode(state.params, jnp.asarray(audio),
                           jnp.asarray(audio_len))
    assert texts[0] == tok.decode(best_seq), (texts, best_seq)
    np.testing.assert_allclose(scores[0], best_score, atol=1e-3)


def test_beam_lm_fusion_changes_hypotheses():
    """Smoke: a nonzero lm_weight actually moves the search (different
    texts or scores on a random AM) — guards against the fused term
    being silently dropped."""
    tok = CharTokenizer()
    cfg, model, state, audio, audio_len = _tiny_am(tok, seed=11)
    cfg.decode.beam_size = 4
    lm, lm_params = _tiny_lm(tok.vocab_size, seed=2)

    base = make_beam_decoder(model, cfg, tok)
    t0, s0 = base(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    cfg.decode.lm_weight = 1.5  # large, to force a visible move
    fused = make_beam_decoder(model, cfg, tok, lm_bundle=(lm, lm_params))
    t1, s1 = fused(state.params, jnp.asarray(audio), jnp.asarray(audio_len))
    assert (t0 != t1) or not np.allclose(np.asarray(s0), np.asarray(s1))
