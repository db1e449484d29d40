"""Interactive-serving decode policy [VERDICT.md round-2 item 5].

At B=1 the joint beam is sequential-step bound (BASELINE.md
single-utterance latency table): the chip idles between tiny dependent
ops, so per-step work and step COUNT are the levers, not FLOPs. The two
safe levers ship as serving defaults:

- partial CTC scoring (``decode.ctc_score_candidates = 2*beam_size``):
  narrows the per-step prefix-score scan from V columns to ~2K,
- end-detect early stopping (``decode.end_detect``): stops the
  while_loop once every recent ending is ``end_detect_d`` below the
  best finished score instead of running to maxlen (measured
  output-identical at the default margin on a trained model).

Applied only when the effective batch size is 1 and the method is a
beam; explicit user overrides always win.
"""

from __future__ import annotations

import sys
from typing import Iterable

from gluon_e2e_asr.config import Config


def apply_b1_serving_defaults(
    config: Config,
    cli_overrides: Iterable[str] = (),
    batch_size: int = None,
) -> None:
    """Mutate ``config.decode`` with the B=1 serving defaults."""
    bs = config.data.batch_size if batch_size is None else int(batch_size)
    if bs != 1 or config.decode.method not in ("beam", "ctc_beam"):
        return
    # dynamic_batch scales per-bucket sizes UP from batch_size (shorter
    # buckets pack more utterances), so batch_size==1 does not imply the
    # effective batch is 1 — don't apply B=1 policy to multi-utterance
    # batches [ADVICE.md round-3].
    if batch_size is None and config.data.dynamic_batch:
        return
    overridden = {k.split("=", 1)[0] for k in (cli_overrides or ())}
    if (config.decode.ctc_score_candidates == 0
            and "decode.ctc_score_candidates" not in overridden):
        config.decode.ctc_score_candidates = 2 * config.decode.beam_size
        print(f"decode: B=1 serving default -> "
              f"ctc_score_candidates={config.decode.ctc_score_candidates}",
              file=sys.stderr)
    if (not config.decode.end_detect
            and "decode.end_detect" not in overridden):
        config.decode.end_detect = True
        print("decode: B=1 serving default -> end_detect=true",
              file=sys.stderr)
