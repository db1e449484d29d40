"""Subword (BPE) tokenizer: merge learning, round trip, determinism,
checkpoint-meta dispatch, and an end-to-end tiny train+decode run
[SURVEY.md §2.1 #2; §4 "Unit: tokenizer/WER"]."""

import json

import numpy as np
import pytest

from gluon_e2e_asr.data.tokenizer import (
    WORD_MARK,
    CharTokenizer,
    SubwordTokenizer,
    build_tokenizer,
    tokenizer_from_json,
)

CORPUS = [
    "the cat sat on the mat",
    "the cats sat",
    "a cat and the mats",
    "the the the",
]


def test_special_id_contract():
    tok = SubwordTokenizer.build_from_texts(CORPUS, vocab_size=40)
    assert tok.blank_id == 0
    assert tok.unk_id == 1
    assert tok.sos_id == 2
    assert tok.eos_id == 3
    assert tok.pad_id == tok.blank_id
    assert tok.vocab_size == len(tok.itos)


def test_merges_learned_and_bounded():
    tok = SubwordTokenizer.build_from_texts(CORPUS, vocab_size=40)
    # "the" is by far the most frequent word; with enough merge budget it
    # must become a single piece (marker included).
    assert WORD_MARK + "the" in tok.stoi
    assert tok.vocab_size <= 40
    # Merge budget is honored exactly unless the corpus ran dry.
    n_base = 4 + len(tok.chars)
    assert len(tok.merges) <= 40 - n_base


def test_round_trip():
    tok = SubwordTokenizer.build_from_texts(CORPUS, vocab_size=48)
    for t in CORPUS + ["cats and mats", "a a a"]:
        assert tok.decode(tok.encode(t)) == t


def test_round_trip_tiny_budget():
    # vocab_size below base inventory -> zero merges, pure char+marker
    # segmentation; round trip must still hold.
    tok = SubwordTokenizer.build_from_texts(CORPUS, vocab_size=1)
    assert tok.merges == []
    assert tok.decode(tok.encode("the cat")) == "the cat"


def test_determinism_independent_of_text_order():
    a = SubwordTokenizer.build_from_texts(CORPUS, vocab_size=40)
    b = SubwordTokenizer.build_from_texts(list(reversed(CORPUS)), 40)
    assert a.to_json() == b.to_json()
    assert a.fingerprint() == b.fingerprint()


def test_unknown_chars_map_to_unk():
    tok = SubwordTokenizer.build_from_texts(CORPUS, vocab_size=40)
    ids = tok.encode("zebra!")  # 'z','b','r','!','e'? e/a/b known? corpus
    # has no 'z' or '!' — those symbols must become unk, not crash.
    assert tok.unk_id in ids
    # decode drops nothing silently: unk renders as the unk string
    assert "<unk>" in tok.decode(ids)


def test_json_round_trip_and_dispatch():
    tok = SubwordTokenizer.build_from_texts(CORPUS, vocab_size=40)
    blob = tok.to_json()
    back = tokenizer_from_json(blob)
    assert isinstance(back, SubwordTokenizer)
    assert back.to_json() == blob
    assert back.encode("the cat") == tok.encode("the cat")
    # Legacy (untyped) char blobs still dispatch to CharTokenizer.
    legacy = CharTokenizer().to_json()
    assert "type" not in json.loads(legacy)
    assert isinstance(tokenizer_from_json(legacy), CharTokenizer)


def test_encode_matches_hand_example():
    # Corpus engineered so the first merge is unambiguous: pairs within
    # "aaab" x3 -> ('a','a') count 6 beats everything; tie-breaks are
    # exercised by ('▁','a') also count 3.
    tok = SubwordTokenizer.build_from_texts(["aaab aaab aaab"], vocab_size=9)
    # base = 4 specials + chars {▁,a,b} = 7 -> budget for 2 merges.
    assert tok.merges[0] == ("a", "a")
    segs = tok._segment("aaab")
    assert "".join(segs) == WORD_MARK + "aaab"


def test_build_tokenizer_dispatch():
    from gluon_e2e_asr.config import Config

    cfg = Config()
    assert isinstance(build_tokenizer(cfg, CORPUS), CharTokenizer)
    cfg.data.tokenizer = "bpe"
    cfg.data.bpe_vocab_size = 40
    tok = build_tokenizer(cfg, CORPUS)
    assert isinstance(tok, SubwordTokenizer)
    with pytest.raises(ValueError):
        cfg.data.tokenizer = "wordpiece"
        build_tokenizer(cfg, CORPUS)


def test_labels_shorter_than_char(tmp_path):
    tok = SubwordTokenizer.build_from_texts(CORPUS, vocab_size=48)
    ctok = CharTokenizer()
    for t in CORPUS:
        assert len(tok.encode(t)) < len(ctok.encode(t))


@pytest.mark.slow
def test_bpe_end_to_end_train_decode(tmp_path):
    """Tiny BPE run: train a few steps, checkpoint, decode restores the
    subword vocab from the meta sidecar and produces text (not ids)."""
    from gluon_e2e_asr import decode as decode_cli
    from gluon_e2e_asr import train as train_cli

    cfgdir = tmp_path / "work"
    cfgdir.mkdir()
    overrides = [
        "data.tokenizer=bpe", "data.bpe_vocab_size=48",
        "data.synth_num_train=8", "data.synth_num_dev=4",
        "data.batch_size=4", "data.bucket_bounds_sec=[2.0]",
        "model.enc_hidden=32", "model.enc_layers=1",
        "model.dec_hidden=32", "model.att_dim=16",
        "train.num_epochs=1", "train.max_steps=2",
    ]
    train_cli.main(["--workdir", str(cfgdir)]
                   + sum((["--set", o] for o in overrides), []))
    import glob
    import os

    ckpts = sorted(glob.glob(str(cfgdir / "ckpts" / "*.msgpack")))
    assert ckpts, os.listdir(str(cfgdir))
    meta = json.load(open(ckpts[-1] + ".json"))
    assert json.loads(meta["vocab"])["type"] == "bpe"

    out = tmp_path / "decode.jsonl"
    decode_cli.main([
        "--ckpt", ckpts[-1], "--output", str(out), "--method", "greedy",
    ] + sum((["--set", o] for o in overrides), []))
    recs = [json.loads(l) for l in open(out) if l.strip()]
    assert recs
    for r in recs:
        if "utt_id" not in r:
            continue
        # Hypotheses must be detokenized text (marker stripped).
        assert WORD_MARK not in r["hyp"]
