"""Per-utterance output fidelity harness [BASELINE.json:L5; SURVEY.md
§2.1 #22]: compare two decode JSONL files utterance by utterance.

Golden workflow: a blessed decode output is checked in (or regenerated
with an explicit flag); CI decodes with the current code and diffs:

    python -m gluon_e2e_asr.decode ... --output new.jsonl
    python tools/fidelity_diff.py golden.jsonl new.jsonl [--score-tol 1e-4]

Exit code 0 iff every utterance's hypothesis matches (and scores agree
within tolerance).
"""

import argparse
import json
import sys


def load(path):
    recs = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                r = json.loads(line)
                recs[r["utt_id"]] = r
    return recs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("golden")
    p.add_argument("candidate")
    p.add_argument("--score-tol", type=float, default=1e-4)
    args = p.parse_args(argv)

    g, c = load(args.golden), load(args.candidate)
    missing = sorted(set(g) - set(c))
    extra = sorted(set(c) - set(g))
    mismatches = []
    for utt_id in sorted(set(g) & set(c)):
        gr, cr = g[utt_id], c[utt_id]
        if gr["hyp"] != cr["hyp"]:
            mismatches.append(
                {"utt_id": utt_id, "kind": "hyp", "golden": gr["hyp"],
                 "candidate": cr["hyp"]}
            )
        elif abs(gr.get("score", 0.0) - cr.get("score", 0.0)) > args.score_tol:
            mismatches.append(
                {"utt_id": utt_id, "kind": "score", "golden": gr["score"],
                 "candidate": cr["score"]}
            )
    report = {
        "compared": len(set(g) & set(c)),
        "missing": missing,
        "extra": extra,
        "mismatches": mismatches,
        "fidelity_ok": not (missing or extra or mismatches),
    }
    print(json.dumps(report, indent=2))
    return 0 if report["fidelity_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
