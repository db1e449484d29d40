"""Regenerate the golden-decode fidelity artifacts [SURVEY.md §2.1 #22;
VERDICT r1 item 5 "goldens enforced in CI"].

Trains the blessed tiny hybrid config (tests/goldens/tiny_golden.yaml)
ON CPU (determinism: CI also runs on CPU), then decodes the 16-utt dev
set with greedy and beam and writes:

    tests/goldens/tiny_golden.msgpack(.json)  — blessed checkpoint
    tests/goldens/golden_greedy.jsonl         — per-utterance records
    tests/goldens/golden_beam.jsonl

Run with --bless to overwrite the checked-in artifacts (only when a
numerics change is INTENTIONAL — the diff gate exists to make silent
divergence loud):

    python tools/make_golden.py --bless
"""

import argparse
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ["JAX_PLATFORMS"] = "cpu"

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

import jax

assert jax.default_backend() == "cpu", jax.default_backend()

GOLD = os.path.join(REPO, "tests", "goldens")
CFG = os.path.join(GOLD, "tiny_golden.yaml")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bless", action="store_true",
                   help="overwrite the checked-in goldens")
    p.add_argument("--workdir", default="/tmp/make_golden")
    args = p.parse_args(argv)

    from gluon_e2e_asr import decode as decode_cli
    from gluon_e2e_asr.config import load_config
    from gluon_e2e_asr.training.trainer import Trainer

    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    config = load_config(CFG)
    trainer = Trainer(config, workdir=args.workdir)
    final = trainer.train()
    print(f"trained: {final}")

    ckpt = os.path.join(args.workdir, config.train.ckpt_dir, "best.msgpack")
    out = {}
    for method in ("greedy", "beam"):
        out[method] = os.path.join(args.workdir, f"golden_{method}.jsonl")
        decode_cli.main([
            "--config", CFG, "--ckpt", ckpt, "--method", method,
            "--output", out[method],
        ])

    if args.bless:
        shutil.copy(ckpt, os.path.join(GOLD, "tiny_golden.msgpack"))
        shutil.copy(ckpt + ".json",
                    os.path.join(GOLD, "tiny_golden.msgpack.json"))
        for method, path in out.items():
            shutil.copy(path, os.path.join(GOLD, f"golden_{method}.jsonl"))
        print(f"blessed new goldens into {GOLD}")
    else:
        print("dry run (no --bless); artifacts left in " + args.workdir)


if __name__ == "__main__":
    main()
