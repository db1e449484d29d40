import pytest

from gluon_e2e_asr.eval.metrics import (
    _edit_distance_py,
    align_counts,
    cer,
    edit_distance,
    error_report,
    wer,
)


@pytest.mark.parametrize(
    "ref,hyp,dist",
    [
        ("", "", 0),
        ("abc", "abc", 0),
        ("abc", "", 3),
        ("", "abc", 3),
        ("kitten", "sitting", 3),
        ("flaw", "lawn", 2),
    ],
)
def test_edit_distance_cases(ref, hyp, dist):
    assert _edit_distance_py(list(ref), list(hyp)) == dist
    assert edit_distance(list(ref), list(hyp)) == dist


def test_wer_words():
    refs = ["the cat sat", "hello world"]
    hyps = ["the cat sat", "hello word"]
    # 1 substitution over 5 reference words
    assert wer(refs, hyps) == pytest.approx(1 / 5)


def test_cer():
    assert cer(["abc"], ["axc"]) == pytest.approx(1 / 3)


@pytest.mark.parametrize(
    "ref,hyp,sdi",
    [
        ("", "", (0, 0, 0, 0)),
        ("abc", "abc", (0, 0, 0, 3)),
        ("abc", "", (0, 3, 0, 0)),
        ("", "abc", (0, 0, 3, 0)),
        ("abc", "axc", (1, 0, 0, 2)),
        ("abc", "ac", (0, 1, 0, 2)),
        ("ac", "abc", (0, 0, 1, 2)),
    ],
)
def test_align_counts_cases(ref, hyp, sdi):
    assert align_counts(list(ref), list(hyp)) == sdi


def test_align_counts_invariants():
    """sub+del+ins == edit distance; sub+del+hits == |ref| on random pairs."""
    import random

    rng = random.Random(7)
    alphabet = "abcd"
    for _ in range(200):
        r = [rng.choice(alphabet) for _ in range(rng.randint(0, 15))]
        h = [rng.choice(alphabet) for _ in range(rng.randint(0, 15))]
        s, d, i, c = align_counts(r, h)
        assert s + d + i == _edit_distance_py(r, h)
        assert s + d + c == len(r)
        assert s + i + c == len(h)


def test_error_report_matches_wer_cer():
    refs = ["the cat sat on the mat", "hello world", ""]
    hyps = ["the cat sit on mat", "hello there world", "oops"]
    rw = error_report(refs, hyps, unit="word")
    assert rw["rate"] == pytest.approx(wer(refs, hyps))
    assert rw["sub_rate"] + rw["del_rate"] + rw["ins_rate"] == pytest.approx(
        rw["rate"])
    rc = error_report(refs, hyps, unit="char")
    assert rc["rate"] == pytest.approx(cer(refs, hyps))
    # Known decomposition for the word case: utt1 has 1 sub (sit) +
    # 1 del (the); utt2 has 1 ins (there); utt3 has 1 ins over 0 refs.
    assert (rw["sub"], rw["del"], rw["ins"]) == (1, 1, 2)


def test_native_matches_python():
    try:
        from gluon_e2e_asr.utils.native import edit_distance_native, get_lib
    except Exception:
        pytest.skip("native module unavailable")
    if get_lib() is None:
        pytest.skip("native toolchain unavailable")
    import random

    rng = random.Random(0)
    alphabet = "abcde"
    for _ in range(50):
        r = [rng.choice(alphabet) for _ in range(rng.randint(0, 12))]
        h = [rng.choice(alphabet) for _ in range(rng.randint(0, 12))]
        assert edit_distance_native(r, h) == _edit_distance_py(r, h)
