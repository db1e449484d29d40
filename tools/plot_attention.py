"""Attention-alignment visualization (the reference family's per-epoch
attention plot reports [SURVEY.md §2.1 #10; INFERRED-high: the
ESPnet-v0-era stacks ship a PlotAttentionReport]): run the LAS decoder
teacher-forced over dev utterances and dump each utterance's attention
matrix [n_tokens+1, enc_frames] as ``.npy`` plus a ``.png`` heatmap.

    python tools/plot_attention.py --config <yaml> --ckpt <ckpt> \
        [--out plots/] [--num 4] [--set KEY=VAL ...]

A well-trained model shows a monotonic diagonal ridge; a diffuse or
collapsed map is the classic mis-training diagnostic this tool exists
to catch early.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import Config, apply_overrides, load_config
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer, tokenizer_from_json
from gluon_e2e_asr.frontend.features import frontend_apply
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.training.checkpoint import restore_checkpoint
from gluon_e2e_asr.training.train_step import (
    create_template_state,
    make_optimizer,
)
from gluon_e2e_asr.training.trainer import build_datasets


def attention_maps(model, params, config, batch, cmvn_stats=None):
    """Teacher-forced attention weights for one padded batch.

    Returns (att [B, L+1, T_enc], enc_len [B]) where row l is the
    attention used to emit output position l (gold inputs
    [sos, y_1..y_L] — forced alignment, the standard report)."""
    feats, feat_len = frontend_apply(
        config.frontend, jnp.asarray(batch["audio"]),
        jnp.asarray(batch["audio_len"]), train=False, cmvn_stats=cmvn_stats,
    )
    enc, enc_len, _ = model.apply({"params": params}, feats, feat_len,
                                  method=model.encode)
    B, T = enc.shape[0], enc.shape[1]
    enc_mask = (jnp.arange(T)[None, :] < enc_len[:, None]).astype(jnp.float32)
    enc_proj = model.apply({"params": params}, enc,
                           method=model.decoder_precompute)
    loc_band = model.apply({"params": params}, T,
                           method=model.decoder_loc_band)
    state = model.apply({"params": params}, B, T,
                        method=model.decoder_init_state)

    labels = jnp.asarray(batch["labels"])
    L = labels.shape[1]
    sos = jnp.full((B,), model.sos_id, jnp.int32)
    tokens_in = jnp.concatenate([sos[:, None], labels], axis=1)  # [B, L+1]

    @jax.jit
    def step(ps, state, token):
        new_state, _ = model.apply(
            {"params": ps}, state, token, enc, enc_proj, enc_mask,
            loc_band, method=model.decoder_step,
        )
        return new_state, new_state["att_w"]

    rows = []
    for l in range(L + 1):
        state, att_w = step(params, state, tokens_in[:, l])
        rows.append(att_w)
    att = jnp.stack(rows, axis=1)  # [B, L+1, T]
    return np.asarray(att), np.asarray(enc_len)


def save_plot(path, att, ref_text):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(att, aspect="auto", origin="lower",
                   interpolation="nearest", cmap="viridis")
    ax.set_xlabel("encoder frames")
    ax.set_ylabel("output positions (teacher-forced)")
    ax.set_title(ref_text[:60])
    fig.colorbar(im, ax=ax, fraction=0.03)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description="attention alignment plots")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--out", type=str, default="att_plots")
    p.add_argument("--num", type=int, default=4)
    p.add_argument("--no-png", action="store_true",
                   help="dump .npy matrices only (no matplotlib)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = p.parse_args(argv)

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if config.loss.mtl_alpha >= 1.0:
        raise SystemExit("CTC-only config has no attention decoder to plot")

    tokenizer = CharTokenizer()
    meta_path = args.ckpt + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta0 = json.load(f)
        if meta0.get("vocab"):
            tokenizer = tokenizer_from_json(meta0["vocab"])

    _, dev_utts = build_datasets(config)
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch,
    )
    sampler = BucketSampler(dev_utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    loader = DataLoader(dev_utts, sampler, tokenizer,
                        config.data.sample_rate,
                        transfer_dtype=config.data.transfer_dtype)
    model = build_model(config, tokenizer.vocab_size, tokenizer.sos_id,
                        tokenizer.eos_id)
    tx = make_optimizer(config)
    first = next(iter(loader.epoch(0)))
    template = create_template_state(
        config, model, tx,
        {"audio": first.audio, "audio_len": first.audio_len,
         "labels": first.labels, "label_len": first.label_len},
    )
    state, cmvn_stats, _ = restore_checkpoint(args.ckpt, template, params_only=True)

    os.makedirs(args.out, exist_ok=True)
    by_id = {u.utt_id: u for u in dev_utts}
    written = []
    for b in loader.epoch(0):
        batch = {"audio": b.audio, "audio_len": b.audio_len,
                 "labels": b.labels, "label_len": b.label_len}
        att, enc_len = attention_maps(model, state.params, config, batch,
                                      cmvn_stats)
        for row, utt_id in enumerate(b.utt_ids):
            n_tok = int(b.label_len[row]) + 1  # + eos position
            a = att[row, :n_tok, : int(enc_len[row])]
            base = os.path.join(args.out, utt_id)
            np.save(base + ".npy", a)
            if not args.no_png:
                save_plot(base + ".png", a, by_id[utt_id].text)
            written.append(utt_id)
            if len(written) >= args.num:
                break
        if len(written) >= args.num:
            break
    print(json.dumps({"event": "attention_plots", "out": args.out,
                      "utts": written}))


if __name__ == "__main__":
    main()
