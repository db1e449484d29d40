"""Global CMVN statistics: a one-shot jitted pass over the training set
[SURVEY.md §2.1 #6 "global stats computed by a one-shot jitted pass,
stored beside ckpt"].

Usage:
    python tools/compute_cmvn.py --config <yaml> --output cmvn.npz
then set frontend.cmvn: global and frontend.cmvn_stats_path: cmvn.npz.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gluon_e2e_asr.utils.platform import configure_from_env

configure_from_env()

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import Config, load_config
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.frontend.features import log_mel_spectrogram, num_frames
from gluon_e2e_asr.training.trainer import build_datasets


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default="")
    p.add_argument("--output", type=str, default="cmvn.npz")
    args = p.parse_args(argv)
    config = load_config(args.config) if args.config else Config()

    train_utts, _ = build_datasets(config)
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch,
    )
    sampler = BucketSampler(train_utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    loader = DataLoader(train_utts, sampler, CharTokenizer(),
                        config.data.sample_rate,
                        transfer_dtype=config.data.transfer_dtype)

    fcfg = config.frontend

    @jax.jit
    def moments(audio, audio_len):
        # Mirror frontend_apply's PCM16 dequant [data.transfer_dtype=
        # int16]: this tool calls log_mel_spectrogram directly (it wants
        # raw per-bin moments, not the CMVN-applied features), so the
        # int16 -> f32 * 2^-15 reconstruction does NOT happen for it
        # automatically. Skipping it inflates every log-mel mean by
        # log(2^30) ~= 20.8 — stats that silently un-normalize training
        # (found in round 5: the ls100 restart trained on mean -17.9
        # "normalized" features and CTC never converged).
        if audio.dtype == jnp.int16:
            audio = audio.astype(jnp.float32) * jnp.float32(2.0 ** -15)
        feats = log_mel_spectrogram(audio, fcfg)
        F = feats.shape[1]
        feat_len = num_frames(audio_len, fcfg.win_length, fcfg.hop_length)
        mask = (jnp.arange(F)[None, :] < feat_len[:, None]).astype(jnp.float32)
        n = mask.sum()
        s1 = (feats * mask[..., None]).sum(axis=(0, 1))
        s2 = (feats**2 * mask[..., None]).sum(axis=(0, 1))
        return n, s1, s2

    tot_n, tot_s1, tot_s2 = 0.0, 0.0, 0.0
    for b in loader.epoch(0):
        n, s1, s2 = moments(jnp.asarray(b.audio), jnp.asarray(b.audio_len))
        tot_n += float(n)
        tot_s1 = tot_s1 + np.asarray(s1, np.float64)
        tot_s2 = tot_s2 + np.asarray(s2, np.float64)
    mean = tot_s1 / max(tot_n, 1.0)
    var = tot_s2 / max(tot_n, 1.0) - mean**2
    std = np.sqrt(np.maximum(var, 1e-10))
    np.savez(args.output, mean=mean.astype(np.float32),
             std=std.astype(np.float32))
    print(f"wrote {args.output}: n={tot_n:.0f} frames, "
          f"mean[0]={mean[0]:.3f}, std[0]={std[0]:.3f}")


if __name__ == "__main__":
    main()
