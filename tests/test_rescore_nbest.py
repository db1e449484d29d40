"""Offline n-best LM rescoring tool (tools/rescore_nbest.py): the
re-ranked winner must be the argmax of am_score + weight * exact LM
sequence log-prob, and the summary WERs must reflect the re-ranking."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, "tools")

from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.models.lm import LSTMLM, lm_logprob, save_lm


def _tiny_lm(vocab_size, seed=0):
    model = LSTMLM(vocab_size=vocab_size, embed_dim=8, hidden=16, layers=1)
    params = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2), jnp.int32),
        jnp.ones((1,), jnp.int32),
    )["params"]
    return model, params


def test_rescore_reranks_by_fused_score(tmp_path, capsys):
    import rescore_nbest

    tok = CharTokenizer()
    model, params = _tiny_lm(tok.vocab_size)
    lm_path = str(tmp_path / "lm.msgpack")
    save_lm(lm_path, params, {
        "vocab_size": tok.vocab_size, "embed_dim": 8, "hidden": 16,
        "layers": 1, "vocab": tok.to_json(),
    })

    cands = ["abc", "abd", "xyz"]
    weight = 5.0  # large so the LM term actually flips the ranking
    records = str(tmp_path / "records.jsonl")
    with open(records, "w") as f:
        f.write(json.dumps({
            "utt_id": "u0", "ref": "abd", "hyp": cands[0],
            "nbest": [{"hyp": c, "score": -1.0 * i}
                      for i, c in enumerate(cands)],
        }) + "\n")

    out = str(tmp_path / "rescored.jsonl")
    rescore_nbest.main([records, "--lm", lm_path,
                        "--weight", str(weight), "--output", out])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    # independent argmax with the exact LM log-prob
    def fused(i, c):
        ids = np.asarray(tok.encode(c), np.int32)
        return -1.0 * i + weight * lm_logprob(
            model, params, ids, tok.eos_id, tok.sos_id)

    want = max(range(len(cands)), key=lambda i: fused(i, cands[i]))
    rec = json.loads(open(out).read().strip())
    assert rec["hyp"] == cands[want]
    assert rec["nbest"][0]["hyp"] == cands[want]
    assert summary["baseline_wer"] == 1.0  # "abc" vs ref "abd"
    assert summary["oracle_wer"] == 0.0  # "abd" is in the list
    assert summary["rescored_wer"] in (0.0, 1.0)
    # scores are the fused quantity
    for c in rec["nbest"]:
        i = cands.index(c["hyp"])
        np.testing.assert_allclose(c["score"], fused(i, c["hyp"]),
                                   rtol=1e-5, atol=1e-4)


def test_rescore_refuses_1best_records(tmp_path):
    import rescore_nbest

    tok = CharTokenizer()
    model, params = _tiny_lm(tok.vocab_size)
    lm_path = str(tmp_path / "lm.msgpack")
    save_lm(lm_path, params, {
        "vocab_size": tok.vocab_size, "embed_dim": 8, "hidden": 16,
        "layers": 1, "vocab": tok.to_json(),
    })
    records = str(tmp_path / "records.jsonl")
    with open(records, "w") as f:
        f.write(json.dumps({"utt_id": "u0", "ref": "a", "hyp": "a"}) + "\n")
    with pytest.raises(SystemExit, match="nbest"):
        rescore_nbest.main([records, "--lm", lm_path])
