"""Fidelity harness tests [SURVEY.md §2.1 #22, §4 'Fidelity']: decode
output is deterministic (same ckpt + data -> identical per-utterance
records) and the diff tool catches divergence."""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "fidelity_diff", os.path.join(REPO, "tools", "fidelity_diff.py")
)
fidelity_diff = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fidelity_diff)


def _write(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def test_diff_tool_pass_and_fail(tmp_path):
    golden = [
        {"utt_id": "a", "hyp": "hello", "score": -1.5},
        {"utt_id": "b", "hyp": "world", "score": -2.0},
    ]
    g = str(tmp_path / "g.jsonl")
    _write(g, golden)

    same = str(tmp_path / "same.jsonl")
    _write(same, list(golden))
    assert fidelity_diff.main([g, same]) == 0

    bad = str(tmp_path / "bad.jsonl")
    _write(bad, [golden[0], {"utt_id": "b", "hyp": "word", "score": -2.0}])
    assert fidelity_diff.main([g, bad]) == 1

    missing = str(tmp_path / "missing.jsonl")
    _write(missing, [golden[0]])
    assert fidelity_diff.main([g, missing]) == 1


def test_decode_deterministic(tmp_path):
    """Same params + audio -> bitwise-identical greedy decode output."""
    from gluon_e2e_asr.config import Config, ModelConfig, LossConfig
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.decoding.greedy import ids_to_texts, make_greedy_decoder
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer,
    )

    cfg = Config(
        model=ModelConfig(enc_hidden=24, enc_layers=1, enc_subsample=(2,)),
        loss=LossConfig(mtl_alpha=1.0),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size)
    rng = np.random.RandomState(0)
    batch = {
        "audio": rng.randn(2, 8000).astype(np.float32) * 0.1,
        "audio_len": np.array([8000, 6000], np.int32),
        "labels": rng.randint(4, 10, (2, 6)).astype(np.int32),
        "label_len": np.array([6, 4], np.int32),
    }
    state = create_train_state(cfg, model, make_optimizer(cfg), batch)
    dec = make_greedy_decoder(model, cfg)
    outs = []
    for _ in range(2):
        ids, lens = dec(state.params, jnp.asarray(batch["audio"]),
                        jnp.asarray(batch["audio_len"]))
        outs.append(ids_to_texts(np.asarray(ids), np.asarray(lens), tok))
    assert outs[0] == outs[1]
