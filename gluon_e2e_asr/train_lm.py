"""External-LM training CLI:
``python -m gluon_e2e_asr.train_lm --config <yaml> --workdir <dir>``.

Trains the shallow-fusion LSTM LM (models/lm.py) on the TRANSCRIPT TEXT
of the configured dataset (plus ``lm.extra_text`` if given) — text
only, no audio. The reference family trains its char RNN-LM exactly
this way [SURVEY.md §2.1 #17; INFERRED-med — fusion is off by default,
see DecodeConfig.lm_weight]. Static-shape discipline: every batch pads
to the single static [batch_size, max_len] shape, so the whole run is
one compiled step.

Emits JSONL metrics {epoch, loss, dev_ppl} and writes the best-dev-ppl
checkpoint to ``<workdir>/<lm.ckpt_path>`` (msgpack + JSON sidecar with
the architecture + vocab fingerprint, which decode.py verifies before
fusing).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gluon_e2e_asr.config import Config, apply_overrides, load_config
from gluon_e2e_asr.data.tokenizer import CharTokenizer, build_tokenizer
from gluon_e2e_asr.models.lm import build_lm, save_lm
from gluon_e2e_asr.utils.logging import JsonlLogger


def gather_texts(config: Config) -> tuple[List[str], List[str], List[str]]:
    """(vocab_texts, train_texts, dev_texts) from the manifests.

    ``vocab_texts`` is the manifest transcripts ONLY — the tokenizer
    must be built from exactly what the ASR trainer sees so the vocab
    fingerprints match at fusion time; ``lm.extra_text`` lines join the
    LM training stream but never the vocab construction."""
    from gluon_e2e_asr.training.trainer import build_datasets

    train_utts, dev_utts = build_datasets(config)
    vocab_texts = [u.text for u in train_utts]
    train = list(vocab_texts)
    dev = [u.text for u in dev_utts]
    if config.lm.extra_text:
        with open(config.lm.extra_text) as f:
            train += [ln.strip() for ln in f if ln.strip()]
    return vocab_texts, train, dev


def make_batches(texts: List[str], tokenizer: CharTokenizer, max_len: int,
                 batch_size: int, rng: np.random.Generator | None):
    """Yield (tokens_in [B,L], targets [B,L], lens [B]) int32 batches.

    Row format: tokens_in = [sos, y_1..y_{n-1}], targets = [y_1..y_n-ish,
    eos] — i.e. position i predicts targets[i]; lens counts valid
    positions (n_tokens + 1 for the eos, capped at max_len). Short final
    batches pad with len-0 rows so the compiled shape never changes."""
    order = np.arange(len(texts))
    if rng is not None:
        rng.shuffle(order)
    B, L = batch_size, max_len
    for start in range(0, len(order), B):
        idx = order[start : start + B]
        tokens_in = np.zeros((B, L), np.int32)
        targets = np.zeros((B, L), np.int32)
        lens = np.zeros((B,), np.int32)
        for row, j in enumerate(idx):
            ids = tokenizer.encode(texts[j])[: L - 1]
            seq_in = [tokenizer.sos_id] + ids
            seq_tgt = ids + [tokenizer.eos_id]
            n = len(seq_in)
            tokens_in[row, :n] = seq_in
            targets[row, :n] = seq_tgt
            lens[row] = n
        yield tokens_in, targets, lens


def make_lm_step(model, lc):
    if lc.warmup_steps > 0:
        sched = optax.join_schedules(
            [
                optax.linear_schedule(0.0, lc.learning_rate, lc.warmup_steps),
                lambda s: lc.learning_rate
                * jnp.sqrt(lc.warmup_steps / jnp.maximum(s + lc.warmup_steps, 1)),
            ],
            [lc.warmup_steps],
        )
    else:
        sched = lc.learning_rate
    tx = optax.chain(optax.clip_by_global_norm(lc.grad_clip_norm),
                     optax.adamw(sched))

    def loss_fn(params, tokens_in, targets, lens):
        logits = model.apply({"params": params}, tokens_in, lens)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        mask = jnp.arange(tokens_in.shape[1])[None, :] < lens[:, None]
        total = jnp.sum(nll * mask)
        count = jnp.maximum(jnp.sum(mask), 1)
        return total / count, count

    @jax.jit
    def train_step(params, opt_state, tokens_in, targets, lens):
        (loss, count), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, tokens_in, targets, lens
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, count

    @jax.jit
    def eval_step(params, tokens_in, targets, lens):
        loss, count = loss_fn(params, tokens_in, targets, lens)
        return loss * count, count  # summed nll, token count

    return tx, train_step, eval_step


def dev_perplexity(eval_step, params, texts, tokenizer, lc) -> float:
    total, count = 0.0, 0
    for ti, tg, ln in make_batches(texts, tokenizer, lc.max_len,
                                   lc.batch_size, rng=None):
        s, c = eval_step(params, jnp.asarray(ti), jnp.asarray(tg),
                         jnp.asarray(ln))
        total += float(s)
        count += int(c)
    return float(np.exp(total / max(count, 1)))


def train_lm(config: Config, workdir: str = ".") -> dict:
    lc = config.lm
    vocab_texts, train_texts, dev_texts = gather_texts(config)
    # Same construction rule as the ASR trainer (data.tokenizer), so a
    # fused/rescoring LM built from the same config shares the ASR
    # vocab bit-for-bit (beam.py cross-checks the fingerprints).
    tokenizer = build_tokenizer(config, vocab_texts)
    model = build_lm(config, tokenizer.vocab_size)
    params = model.init(
        jax.random.PRNGKey(lc.seed),
        jnp.zeros((1, 2), jnp.int32), jnp.ones((1,), jnp.int32),
    )["params"]
    tx, train_step, eval_step = make_lm_step(model, lc)
    opt_state = tx.init(params)
    logger = JsonlLogger(os.path.join(workdir, "lm_metrics.jsonl"))

    ckpt = os.path.join(workdir, lc.ckpt_path)
    best_ppl = float("inf")
    rng = np.random.default_rng(lc.seed)
    last_loss = float("nan")
    for epoch in range(lc.num_epochs):
        tot, cnt = 0.0, 0
        for ti, tg, ln in make_batches(train_texts, tokenizer, lc.max_len,
                                       lc.batch_size, rng):
            params, opt_state, loss, count = train_step(
                params, opt_state, jnp.asarray(ti), jnp.asarray(tg),
                jnp.asarray(ln),
            )
            tot += float(loss) * int(count)
            cnt += int(count)
        last_loss = tot / max(cnt, 1)
        ppl = dev_perplexity(eval_step, params, dev_texts, tokenizer, lc)
        logger.log({"event": "lm_epoch", "epoch": epoch,
                    "loss": round(last_loss, 4), "dev_ppl": round(ppl, 3)})
        if ppl < best_ppl:
            best_ppl = ppl
            save_lm(ckpt, params, {
                "vocab_size": tokenizer.vocab_size,
                "embed_dim": lc.embed_dim,
                "hidden": lc.hidden,
                "layers": lc.layers,
                "vocab": tokenizer.to_json(),
                "dev_ppl": ppl,
                "epoch": epoch,
            })
    logger.close()
    return {"ckpt": ckpt, "best_dev_ppl": best_ppl, "final_loss": last_loss}


def main(argv=None):
    p = argparse.ArgumentParser(description="LM training "
                                "(shallow-fusion LSTM LM)")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--workdir", type=str, default=".")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = p.parse_args(argv)
    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    result = train_lm(config, workdir=args.workdir)
    print(json.dumps({"event": "lm_done", **result}, default=float))
    return result


if __name__ == "__main__":
    main()
