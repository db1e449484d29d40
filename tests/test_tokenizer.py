from gluon_e2e_asr.data.tokenizer import CharTokenizer


def test_special_ids():
    tok = CharTokenizer()
    assert tok.blank_id == 0
    assert tok.unk_id == 1
    assert tok.sos_id == 2
    assert tok.eos_id == 3
    assert tok.vocab_size == 4 + len(tok.alphabet)


def test_roundtrip():
    tok = CharTokenizer()
    text = "hello world"
    ids = tok.encode(text)
    assert tok.decode(ids) == text


def test_unk_and_case():
    tok = CharTokenizer()
    ids = tok.encode("AbC@")
    assert ids[:3] == tok.encode("abc")
    assert ids[3] == tok.unk_id


def test_decode_skips_specials():
    tok = CharTokenizer()
    ids = [tok.sos_id] + tok.encode("hi") + [tok.blank_id, tok.eos_id]
    assert tok.decode(ids) == "hi"


def test_serialization_roundtrip():
    tok = CharTokenizer()
    tok2 = CharTokenizer.from_json(tok.to_json())
    assert tok2.itos == tok.itos
    assert tok2.fingerprint() == tok.fingerprint()
