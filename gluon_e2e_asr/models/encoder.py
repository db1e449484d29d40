"""Pyramidal BiLSTM encoder + CTC projection head.

Reference-side realization: Gluon ``rnn.LSTM`` blocks over MXNet's C++
fused RNN ops [SURVEY.md §2.1 #8]. New-repo realization: stacked
bidirectional ``lax.scan`` LSTM layers with optional frame-pair
time subsampling between layers [BASELINE.json:L5,L7; SURVEY.md §2.1 #8
"pyramidal/stride subsampling"].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gluon_e2e_asr.config import ModelConfig
from gluon_e2e_asr.models.lstm import bilstm_scan
from gluon_e2e_asr.models.module import (
    Module, ParamKeys, Params, conv2d_params, conv2d_same, dense,
    dense_params, dropout, lecun_normal, max_pool_2x2, orthogonal, zeros,
)


def subsample_concat(x: jnp.ndarray, lens: jnp.ndarray, factor: int):
    """Pyramidal reduction: concatenate ``factor`` consecutive frames and
    stride by ``factor``. [B,T,D] -> [B,ceil(T/f),f*D]; len -> ceil(len/f)."""
    if factor == 1:
        return x, lens
    B, T, D = x.shape
    pad = (-T) % factor
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
    x = x.reshape(B, (T + pad) // factor, factor * D)
    new_lens = (lens + factor - 1) // factor
    return x, new_lens


class VGG2L(Module):
    """VGG2L conv front: per stage, (3x3 conv + ReLU) x2 then 2x2 max-pool.

    The family's standard conv-subsampling encoder front ("vggblstm"
    [SURVEY.md §2.1 #8, INFERRED-med for the conv variant]): NHWC
    convolutions in ``compute_dtype`` — large batched convs, static
    shapes, no custom kernel. Each stage halves both time and feature
    axes (SAME pooling, so lens map as ceil(len/2) per stage); frames
    past the reduced length are re-zeroed after every stage so padded
    buckets stay deterministic and bucket-size-invariant (the frontend
    contract, frontend/features.py::compute_features).
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def _check_dim(self, D: int) -> int:
        C = int(self.cfg.vgg_in_channels)
        if D % C != 0:
            raise ValueError(
                f"feature dim {D} is not divisible by vgg_in_channels={C} "
                "(set vgg_in_channels = 1 + frontend.deltas)"
            )
        return D // C

    def init_params(self, keys: ParamKeys, feats, lens=None,
                    cdtype=None) -> Params:
        cfg = self.cfg
        self._check_dim(feats.shape[-1])
        c_in, p = int(cfg.vgg_in_channels), {}
        for stage, ch in enumerate(cfg.vgg_channels):
            for sub in range(2):
                name = f"conv{stage + 1}_{sub + 1}"
                p[name] = conv2d_params(keys.child(name), c_in, int(ch))
                c_in = int(ch)
        return p

    def out_dim(self, D: int) -> int:
        """Output feature width for input width ``D``."""
        F = self._check_dim(D)
        for _ in self.cfg.vgg_channels:
            F = (F + 1) // 2
        return F * int(self.cfg.vgg_channels[-1])

    def __call__(self, p, feats: jnp.ndarray, lens: jnp.ndarray, cdtype):
        cfg = self.cfg
        B, T, D = feats.shape
        C = int(cfg.vgg_in_channels)
        F = self._check_dim(D)
        # Deltas concatenate [static | d | dd] along the feature axis;
        # unstack those blocks into conv input channels: [B,T,F,C].
        x = feats.reshape(B, T, C, F).transpose(0, 1, 3, 2).astype(cdtype)
        for stage, ch in enumerate(cfg.vgg_channels):
            # Conv bias + ReLU make padded frames nonzero; re-zero after
            # EVERY conv so the next conv's boundary window sees zeros
            # regardless of how far the bucket is padded (otherwise a
            # relu(bias) frame just past ``lens`` leaks into the last
            # valid frames and breaks bucket-size invariance).
            valid = (jnp.arange(x.shape[1])[None, :] < lens[:, None])
            for sub in range(2):
                x = conv2d_same(p[f"conv{stage + 1}_{sub + 1}"], x, cdtype)
                x = jax.nn.relu(x)
                x = jnp.where(valid[:, :, None, None], x, 0)
            # SAME pooling == ceil(T/2): every valid frame lands in a
            # window whose start index is even, independent of bucket T.
            x = max_pool_2x2(x)
            lens = (lens + 1) // 2
        Tr, Fr, Cr = x.shape[1], x.shape[2], x.shape[3]
        # Hand the LSTM stack f32, matching the frontend's output contract
        # (each layer casts to compute_dtype internally).
        out = x.reshape(B, Tr, Fr * Cr).astype(jnp.float32)
        return out, lens.astype(jnp.int32)


class BiLSTMEncoder(Module):
    """Stacked BiLSTM with per-layer subsampling and a CTC head."""

    def __init__(self, cfg: ModelConfig, vocab_size: int):
        self.cfg = cfg
        self.vocab_size = vocab_size

    def _subsample(self):
        cfg = self.cfg
        return tuple(cfg.enc_subsample) + (1,) * max(
            0, cfg.enc_layers - len(cfg.enc_subsample)
        )

    def init_params(self, keys: ParamKeys, feats, feat_len=None,
                    train: bool = False, dropout_rng=None) -> Params:
        cfg = self.cfg
        p: Params = {}
        D = feats.shape[-1]
        if cfg.enc_type == "vggblstm":
            vgg = VGG2L(cfg)
            p["vgg"] = vgg.init_params(keys.child("vgg"), feats)
            D = vgg.out_dim(D)
        elif cfg.enc_type != "blstm":
            raise ValueError(f"unknown enc_type {cfg.enc_type!r}")
        H = cfg.enc_hidden
        for layer, f in enumerate(self._subsample()[: cfg.enc_layers]):
            D = D * int(f)
            # One input projection for both directions [D, 8H].
            p[f"l{layer}_in_w"] = keys(lecun_normal, (D, 8 * H))
            p[f"l{layer}_in_b"] = keys(zeros, (8 * H,))
            p[f"l{layer}_rec_f"] = keys(orthogonal, (H, 4 * H))
            p[f"l{layer}_rec_b"] = keys(orthogonal, (H, 4 * H))
            D = 2 * H
        p["ctc_head"] = dense_params(keys.child("ctc_head"), D,
                                     self.vocab_size)
        return p

    def __call__(self, p, feats: jnp.ndarray, feat_len: jnp.ndarray,
                 train: bool = False, dropout_rng=None):
        cfg = self.cfg
        cdtype = jnp.dtype(cfg.compute_dtype)
        x, lens = feats, feat_len
        if cfg.enc_type == "vggblstm":
            x, lens = VGG2L(cfg)(p["vgg"], x, lens, cdtype)
        elif cfg.enc_type != "blstm":
            raise ValueError(f"unknown enc_type {cfg.enc_type!r}")
        subs = self._subsample()
        for layer in range(cfg.enc_layers):
            x, lens = subsample_concat(x, lens, int(subs[layer]))
            xg = (
                jnp.dot(x.astype(cdtype), p[f"l{layer}_in_w"].astype(cdtype),
                        preferred_element_type=jnp.float32)
                + p[f"l{layer}_in_b"]
            ).astype(cdtype)
            xg_f, xg_b = jnp.split(xg, 2, axis=-1)
            scan_fn = functools.partial(bilstm_scan, compute_dtype=cdtype)
            if cfg.remat:
                # Recompute the scan in the backward pass instead of
                # storing per-step activations (O(1) residency for
                # long buckets).
                scan_fn = jax.checkpoint(scan_fn)
            x = scan_fn(xg_f, xg_b, lens, p[f"l{layer}_rec_f"],
                        p[f"l{layer}_rec_b"])  # [B, T, 2H]
            if train and cfg.enc_dropout > 0.0 and dropout_rng is not None:
                # independent mask per layer
                layer_rng = jax.random.fold_in(dropout_rng, layer)
                x = dropout(x, cfg.enc_dropout, layer_rng)
        # CTC projection head [SURVEY.md §2.1 #9]; loss applies log_softmax.
        ctc_logits = dense(p["ctc_head"], x, cdtype).astype(jnp.float32)
        return x, lens.astype(jnp.int32), ctc_logits
