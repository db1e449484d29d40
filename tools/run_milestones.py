"""Run every milestone config end to end (train -> decode) and print a
summary table [BASELINE.json:L6-L12]. Milestone 2 (the fused frontend
kernel) was retired with the kernel.

    python tools/run_milestones.py [--workdir /tmp/milestones] [--only 1,3]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

CONFIGS = [
    ("m1", "configs/milestone1_bilstm_ctc.yaml"),
    ("m3", "configs/milestone3_las.yaml"),
    ("m4", "configs/milestone4_hybrid_dp.yaml"),
    ("m5", "configs/milestone5_beam.yaml"),
]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="/tmp/milestones")
    p.add_argument("--only", default="",
                   help="comma-separated milestone numbers, e.g. 1,5")
    args = p.parse_args(argv)
    only = {f"m{s.strip()}" for s in args.only.split(",") if s.strip()}

    from gluon_e2e_asr.config import load_config
    from gluon_e2e_asr.training.trainer import Trainer
    from gluon_e2e_asr import decode as decode_cli

    results = []
    for name, cfg_path in CONFIGS:
        if only and name not in only:
            continue
        wd = os.path.join(args.workdir, name)
        os.makedirs(wd, exist_ok=True)
        config = load_config(cfg_path)
        t0 = time.perf_counter()
        trainer = Trainer(config, workdir=wd)
        final = trainer.train()
        train_time = time.perf_counter() - t0
        ckpt = os.path.join(wd, config.train.ckpt_dir, "best.msgpack")
        dec = decode_cli.main([
            "--config", cfg_path, "--ckpt", ckpt,
            "--output", os.path.join(wd, "decode.jsonl"),
        ])
        row = {
            "milestone": name,
            "train_steps": final.get("step"),
            "train_time_s": round(train_time, 1),
            "utt_per_sec_per_chip": final.get("utt_per_sec_per_chip"),
            "dev_wer": dec["wer"],
            "dev_cer": dec["cer"],
            "p50_latency_s": dec["p50_latency_s"],
            "method": dec["method"],
        }
        results.append(row)
        print(json.dumps({"event": "milestone_done", **row}))
    print(json.dumps({"event": "all_milestones", "results": results}, indent=2))


if __name__ == "__main__":
    main()
