"""Train CLI: ``python -m gluon_e2e_asr.train --config <yaml>``.

The public train entry point [BASELINE.json:L5 "matching the
reference's public train/decode API"; SURVEY.md §1 L7]. The reference's
own CLI shape was unobservable (empty mount), so this CLI is the
canonical one [SURVEY.md §0 rule].
"""

from __future__ import annotations

import argparse
import json

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

from gluon_e2e_asr.config import Config, apply_overrides, load_config
from gluon_e2e_asr.training.trainer import Trainer


def main(argv=None):
    p = argparse.ArgumentParser(description="E2E ASR training")
    p.add_argument("--config", type=str, default="", help="yaml config path")
    p.add_argument("--workdir", type=str, default=".", help="output directory")
    p.add_argument("--resume", action="store_true",
                   help="resume from latest checkpoint in workdir")
    p.add_argument("--max-steps", type=int, default=0,
                   help="override train.max_steps (0 = keep config)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="dotted config override, e.g. model.att_type=dot "
                        "(repeatable)")
    args = p.parse_args(argv)

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if args.max_steps:
        config.train.max_steps = args.max_steps

    trainer = Trainer(config, workdir=args.workdir)
    if args.resume:
        trainer.maybe_resume()
    final = trainer.train()
    print(json.dumps({"event": "done", **final}, default=float))


if __name__ == "__main__":
    main()
