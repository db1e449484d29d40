"""Golden-decode fidelity gate [SURVEY.md §2.1 #22; VERDICT r1 item 5]:
decode the blessed tiny checkpoint with the CURRENT code and diff the
per-utterance records against the checked-in goldens.

The tiny model's transcript *quality* is irrelevant here (it is
deliberately small and undertrained); what the gate enforces is that
the full frontend -> encoder -> decoder -> search -> detokenize path is
bitwise-stable on CPU. Any unintentional numerics change flips a
hypothesis or a beam score and fails loudly. Intentional changes:
re-bless with  python tools/make_golden.py --bless.
"""

import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")

spec = importlib.util.spec_from_file_location(
    "fidelity_diff", os.path.join(REPO, "tools", "fidelity_diff.py")
)
fidelity_diff = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fidelity_diff)


def _decode(method, out_path):
    from gluon_e2e_asr import decode as decode_cli

    return decode_cli.main([
        "--config", os.path.join(GOLD, "tiny_golden.yaml"),
        "--ckpt", os.path.join(GOLD, "tiny_golden.msgpack"),
        "--method", method,
        "--output", str(out_path),
    ])


def test_greedy_matches_golden(tmp_path):
    out = tmp_path / "greedy.jsonl"
    _decode("greedy", out)
    rc = fidelity_diff.main(
        [os.path.join(GOLD, "golden_greedy.jsonl"), str(out)]
    )
    assert rc == 0, "greedy decode diverged from blessed golden"


def test_beam_matches_golden(tmp_path):
    out = tmp_path / "beam.jsonl"
    _decode("beam", out)
    rc = fidelity_diff.main(
        [os.path.join(GOLD, "golden_beam.jsonl"), str(out)]
    )
    assert rc == 0, "beam decode diverged from blessed golden"
