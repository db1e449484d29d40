"""The hybrid CTC/attention ASR model: encoder + CTC head + LAS decoder.

Glues [SURVEY.md §1 L3] together. The acoustic frontend stays a pure
function (``frontend.frontend_apply``) called inside the jitted
train/decode step — it has no learnable parameters, only CMVN stats
carried beside the checkpoint [SURVEY.md §2.1 #6].
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax.numpy as jnp

from gluon_e2e_asr.config import Config, ModelConfig
from gluon_e2e_asr.models.decoder import AttentionDecoder
from gluon_e2e_asr.models.encoder import BiLSTMEncoder
from gluon_e2e_asr.models.module import Module, ParamKeys, Params


class ASRModel(Module):
    def __init__(self, cfg: ModelConfig, vocab_size: int, sos_id: int = 2,
                 eos_id: int = 3, use_decoder: bool = True):
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.sos_id = sos_id
        self.eos_id = eos_id
        self.use_decoder = use_decoder
        self.encoder = BiLSTMEncoder(cfg, vocab_size)
        self.decoder = (AttentionDecoder(cfg, vocab_size, sos_id, eos_id)
                        if use_decoder else None)

    def init_params(self, keys: ParamKeys, feats, feat_len=None,
                    tokens_in=None, *args, **kwargs) -> Params:
        p = {"encoder": self.encoder.init_params(keys.child("encoder"),
                                                 feats)}
        if self.use_decoder:
            p["decoder"] = self.decoder.init_params(keys.child("decoder"))
        return p

    def __call__(
        self,
        p: Params,
        feats: jnp.ndarray,
        feat_len: jnp.ndarray,
        tokens_in: Optional[jnp.ndarray] = None,
        ss_prob: float = 0.0,
        ss_rng=None,
        train: bool = False,
        dropout_rng=None,
    ) -> Dict[str, Any]:
        enc, enc_len, ctc_logits = self.encoder(
            p["encoder"], feats, feat_len, train, dropout_rng)
        out = {"enc": enc, "enc_len": enc_len, "ctc_logits": ctc_logits}
        if self.use_decoder and tokens_in is not None:
            out["att_logits"] = self.decoder(
                p["decoder"], enc, enc_len, tokens_in, ss_prob, ss_rng)
        return out

    # Exposed sub-paths for decoding [SURVEY.md §3.2].
    def encode(self, p, feats, feat_len):
        return self.encoder(p["encoder"], feats, feat_len, train=False)

    def decoder_precompute(self, p, enc):
        return self.decoder.precompute(p["decoder"], enc)

    def decoder_init_state(self, p, batch, enc_frames):
        return self.decoder.init_state(p["decoder"], batch, enc_frames)

    def decoder_step(self, p, state, token, enc, enc_proj, enc_mask,
                     loc_band=None):
        return self.decoder.step(p["decoder"], state, token, enc, enc_proj,
                                 enc_mask, loc_band)

    def decoder_init_state_beam(self, p, batch, beams, enc_frames):
        return self.decoder.init_state_beam(p["decoder"], batch, beams,
                                            enc_frames)

    def decoder_step_beam(self, p, state, token, enc, enc_proj, enc_mask,
                          beams, loc_band=None):
        return self.decoder.step_beam(p["decoder"], state, token, enc,
                                      enc_proj, enc_mask, beams, loc_band)

    def decoder_loc_band(self, p, enc_frames):
        if self.cfg.att_type != "loc":
            return None
        return self.decoder.build_loc_band(p["decoder"], enc_frames)


def build_model(config: Config, vocab_size: int, sos_id: int = 2,
                eos_id: int = 3, use_decoder: Optional[bool] = None) -> ASRModel:
    if use_decoder is None:
        # Milestone 1 is encoder+CTC only [BASELINE.json:L7]; the hybrid
        # configs add the attention decoder [BASELINE.json:L9,L10].
        use_decoder = config.loss.mtl_alpha < 1.0
    if config.train.remat_encoder:
        config.model.remat = True
    if config.model.enc_type == "vggblstm":
        # The VGG front unstacks delta blocks into conv input channels;
        # a mismatch would silently treat deltas as extra frequency bins
        # (the bare divisibility check passes at vgg_in_channels=1)
        # [ADVICE.md round-2 #2].
        want = 1 + int(config.frontend.deltas)
        if int(config.model.vgg_in_channels) != want:
            raise ValueError(
                f"model.vgg_in_channels={config.model.vgg_in_channels} must "
                f"equal 1 + frontend.deltas = {want} for enc_type=vggblstm"
            )
    return ASRModel(
        cfg=config.model,
        vocab_size=vocab_size,
        sos_id=sos_id,
        eos_id=eos_id,
        use_decoder=use_decoder,
    )
