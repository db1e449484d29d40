"""Decoder-free CTC prefix beam search (decode.method: ctc_beam)
[SURVEY.md §2.1 #16/#17 family]. Label-synchronous exact prefix search:
every extension is ranked by its exact CTC prefix probability, so the
full-width beam must reproduce a brute-force argmax over all sequences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import Config, DecodeConfig, LossConfig, ModelConfig
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.decoding.beam import make_beam_decoder
from gluon_e2e_asr.frontend.features import frontend_apply
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.ops.ctc import ctc_forward_alpha
from gluon_e2e_asr.training.train_step import (
    create_train_state,
    make_optimizer,
)


def _ctc_only_setup(seed=0, n_samples=4000):
    cfg = Config(
        model=ModelConfig(enc_hidden=24, enc_layers=1, enc_subsample=(2,)),
        loss=LossConfig(mtl_alpha=1.0),  # CTC-only: no attention decoder
        decode=DecodeConfig(method="ctc_beam", beam_size=4,
                            maxlen_ratio=0.6, length_norm=True),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    assert not model.use_decoder
    rng = np.random.RandomState(seed)
    audio = rng.randn(2, n_samples).astype(np.float32) * 0.1
    audio_len = np.array([n_samples, int(n_samples * 0.7)], np.int32)
    batch = {
        "audio": audio, "audio_len": audio_len,
        "labels": rng.randint(4, 10, (2, 6)).astype(np.int32),
        "label_len": np.array([6, 4], np.int32),
    }
    state = create_train_state(cfg, model, make_optimizer(cfg), batch)
    return cfg, tok, model, state, audio, audio_len


def _seq_logprob(logp, T_len, seq):
    """Exact log P_ctc(seq) via the validated forward algorithm."""
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


def test_ctc_beam_runs_without_decoder():
    cfg, tok, model, state, audio, audio_len = _ctc_only_setup()
    decode = make_beam_decoder(model, cfg, tok)
    texts, scores = decode(state.params, jnp.asarray(audio),
                           jnp.asarray(audio_len))
    assert len(texts) == 2
    assert np.isfinite(scores).all()
    for t in texts:
        assert all(ch in tok.alphabet for ch in t), t


def test_hybrid_beam_refuses_ctc_only_model():
    cfg, tok, model, state, audio, audio_len = _ctc_only_setup()
    cfg.decode.method = "beam"
    with pytest.raises(ValueError, match="attention decoder"):
        make_beam_decoder(model, cfg, tok)


@pytest.mark.slow
def test_ctc_beam_full_width_matches_exhaustive_search():
    """Full-width ctc_beam == brute-force argmax of the exact CTC
    likelihood over every sequence of length <= maxlen-1 (end-to-end
    validation of the psi ranking, finished buffer, and eos scoring)."""
    cfg, tok, model, state, audio, audio_len = _ctc_only_setup(seed=7)
    audio, audio_len = audio[:1], audio_len[:1]  # B=1

    feats, feat_len = frontend_apply(cfg.frontend, jnp.asarray(audio),
                                     jnp.asarray(audio_len), train=False)
    _, enc_len, ctc_logits = model.apply(
        {"params": state.params}, feats, feat_len, method=model.encode)
    logp = np.asarray(jax.nn.log_softmax(ctc_logits, axis=-1))[0]
    T_len = int(enc_len[0])

    maxlen = 3  # sequences of length 0..2 finalize
    cfg.decode.maxlen_ratio = maxlen / float(enc_len[0])
    cfg.decode.length_norm = False

    allowed = [i for i in range(tok.vocab_size)
               if i not in (tok.blank_id, tok.sos_id, tok.eos_id,
                            tok.unk_id)]
    A = len(allowed)
    cfg.decode.beam_size = 1 + A + A * A  # every prefix survives

    best_score, best_seq = _seq_logprob(logp, T_len, []), []
    for c in allowed:
        s1 = _seq_logprob(logp, T_len, [c])
        if s1 > best_score:
            best_score, best_seq = s1, [c]
        for d in allowed:
            s2 = _seq_logprob(logp, T_len, [c, d])
            if s2 > best_score:
                best_score, best_seq = s2, [c, d]

    decode = make_beam_decoder(model, cfg, tok)
    texts, scores = decode(state.params, jnp.asarray(audio),
                           jnp.asarray(audio_len))
    assert texts[0] == tok.decode(best_seq), (texts, best_seq)
    np.testing.assert_allclose(scores[0], best_score, rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_ctc_beam_partial_covering_candidates_match_full():
    """Static CTC-posterior candidate pruning with N >= every usable
    token must reproduce full-vocab ctc_beam bitwise."""
    cfg, tok, model, state, audio, audio_len = _ctc_only_setup(seed=3)
    decode_full = make_beam_decoder(model, cfg, tok)
    t_full, s_full = decode_full(state.params, jnp.asarray(audio),
                                 jnp.asarray(audio_len))
    cfg.decode.ctc_score_candidates = tok.vocab_size - 4  # all non-special
    decode_part = make_beam_decoder(model, cfg, tok)
    t_part, s_part = decode_part(state.params, jnp.asarray(audio),
                                 jnp.asarray(audio_len))
    assert t_full == t_part
    np.testing.assert_allclose(s_full, s_part, rtol=1e-5)
