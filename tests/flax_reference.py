"""The models as flax.linen modules, as they were written before the
models became plain JAX. Tests compare the plain-JAX models against
these: same parameter tree, same initial weights for a seed, same
outputs. Import only after ``pytest.importorskip("flax")``."""

from __future__ import annotations

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp

from gluon_e2e_asr.models.encoder import subsample_concat
from gluon_e2e_asr.models.lstm import bilstm_scan, lstm_cell_step, lstm_scan


class VGG2L(nn.Module):
    cfg: object

    @nn.compact
    def __call__(self, feats, lens, cdtype):
        cfg = self.cfg
        B, T, D = feats.shape
        C = int(cfg.vgg_in_channels)
        F = D // C
        x = feats.reshape(B, T, C, F).transpose(0, 1, 3, 2).astype(cdtype)
        for stage, ch in enumerate(cfg.vgg_channels):
            valid = (jnp.arange(x.shape[1])[None, :] < lens[:, None])
            for sub in range(2):
                x = nn.Conv(int(ch), (3, 3), padding="SAME", dtype=cdtype,
                            name=f"conv{stage + 1}_{sub + 1}")(x)
                x = nn.relu(x)
                x = jnp.where(valid[:, :, None, None], x, 0)
            x = nn.max_pool(x, (2, 2), strides=(2, 2), padding="SAME")
            lens = (lens + 1) // 2
        Tr, Fr, Cr = x.shape[1], x.shape[2], x.shape[3]
        return x.reshape(B, Tr, Fr * Cr).astype(jnp.float32), lens


class BiLSTMEncoder(nn.Module):
    cfg: object
    vocab_size: int

    @nn.compact
    def __call__(self, feats, feat_len, train=False, dropout_rng=None):
        cfg = self.cfg
        cdtype = jnp.dtype(cfg.compute_dtype)
        x, lens = feats, feat_len
        if cfg.enc_type == "vggblstm":
            x, lens = VGG2L(cfg, name="vgg")(x, lens, cdtype)
        subs = tuple(cfg.enc_subsample) + (1,) * max(
            0, cfg.enc_layers - len(cfg.enc_subsample))
        for layer in range(cfg.enc_layers):
            x, lens = subsample_concat(x, lens, int(subs[layer]))
            H, D = cfg.enc_hidden, x.shape[-1]
            w_in = self.param(f"l{layer}_in_w", nn.initializers.lecun_normal(),
                              (D, 8 * H))
            b_in = self.param(f"l{layer}_in_b", nn.initializers.zeros,
                              (8 * H,))
            w_hf = self.param(f"l{layer}_rec_f", nn.initializers.orthogonal(),
                              (H, 4 * H))
            w_hb = self.param(f"l{layer}_rec_b", nn.initializers.orthogonal(),
                              (H, 4 * H))
            xg = (jnp.dot(x.astype(cdtype), w_in.astype(cdtype),
                          preferred_element_type=jnp.float32)
                  + b_in).astype(cdtype)
            xg_f, xg_b = jnp.split(xg, 2, axis=-1)
            x = functools.partial(bilstm_scan, compute_dtype=cdtype)(
                xg_f, xg_b, lens, w_hf, w_hb)
            if train and cfg.enc_dropout > 0.0 and dropout_rng is not None:
                layer_rng = jax.random.fold_in(dropout_rng, layer)
                x = nn.Dropout(cfg.enc_dropout, deterministic=False)(
                    x, rng=layer_rng)
        ctc_logits = nn.Dense(self.vocab_size, dtype=cdtype, name="ctc_head")(
            x.astype(cdtype)).astype(jnp.float32)
        return x, lens.astype(jnp.int32), ctc_logits


class AttentionDecoder(nn.Module):
    cfg: object
    vocab_size: int

    def setup(self):
        cfg = self.cfg
        V, E, H, A = self.vocab_size, cfg.dec_embed, cfg.dec_hidden, cfg.att_dim
        enc_dim = 2 * cfg.enc_hidden
        init = nn.initializers
        self.embed = self.param("embed", init.normal(1.0 / (E ** 0.5)), (V, E))
        in_dims = [E + enc_dim] + [H] * (cfg.dec_layers - 1)
        self.w_x = [self.param(f"cell{l}_wx", init.lecun_normal(),
                               (in_dims[l], 4 * H))
                    for l in range(cfg.dec_layers)]
        self.b_x = [self.param(f"cell{l}_b", init.zeros, (4 * H,))
                    for l in range(cfg.dec_layers)]
        self.w_h = [self.param(f"cell{l}_wh", init.orthogonal(), (H, 4 * H))
                    for l in range(cfg.dec_layers)]
        self.att_q = self.param("att_q", init.lecun_normal(), (H, A))
        self.att_k = self.param("att_k", init.lecun_normal(), (enc_dim, A))
        if cfg.att_type in ("add", "loc"):
            self.att_b = self.param("att_b", init.zeros, (A,))
            self.att_v = self.param("att_v", init.lecun_normal(), (A, 1))
        if cfg.att_type == "loc":
            self.loc_filter = self.param(
                "loc_filter", init.lecun_normal(),
                (cfg.loc_conv_width, 1, cfg.loc_conv_channels))
            self.loc_proj = self.param("loc_proj", init.lecun_normal(),
                                       (cfg.loc_conv_channels, A))
        self.w_out = self.param("out_w", init.lecun_normal(), (H + enc_dim, V))
        self.b_out = self.param("out_b", init.zeros, (V,))

    def _attend(self, query, enc, enc_proj, enc_mask, att_prev):
        cfg = self.cfg
        q = jnp.dot(query, self.att_q, preferred_element_type=jnp.float32)
        if cfg.att_type == "dot":
            scores = jnp.einsum("ba,bta->bt", q, enc_proj) / jnp.sqrt(
                jnp.asarray(cfg.att_dim, jnp.float32))
        else:
            e = q[:, None, :] + enc_proj + self.att_b
            if cfg.att_type == "loc":
                f = jax.lax.conv_general_dilated(
                    att_prev[:, :, None], self.loc_filter,
                    window_strides=(1,), padding="SAME",
                    dimension_numbers=("NWC", "WIO", "NWC"))
                e = e + jnp.dot(f, self.loc_proj,
                                preferred_element_type=jnp.float32)
            scores = (jnp.tanh(e) @ self.att_v)[..., 0]
        scores = jnp.where(enc_mask, scores, -1e30)
        att_w = jax.nn.softmax(scores, axis=-1) * enc_mask
        return jnp.einsum("bt,btd->bd", att_w, enc), att_w

    def __call__(self, enc, enc_len, tokens_in):
        cfg = self.cfg
        B, T = enc.shape[0], enc.shape[1]
        cdtype = jnp.dtype(cfg.compute_dtype)
        enc_mask = (jnp.arange(T)[None, :] < enc_len[:, None]).astype(
            jnp.float32)
        enc_proj = jnp.dot(enc.astype(cdtype), self.att_k.astype(cdtype),
                           preferred_element_type=jnp.float32)
        H = cfg.dec_hidden
        state = {"h": jnp.zeros((cfg.dec_layers, B, H)),
                 "c": jnp.zeros((cfg.dec_layers, B, H)),
                 "att_w": jnp.zeros((B, T)),
                 "context": jnp.zeros((B, 2 * cfg.enc_hidden))}
        outs = []
        for t in range(tokens_in.shape[1]):
            x = jnp.concatenate([self.embed[tokens_in[:, t]],
                                 state["context"]], axis=-1)
            hs, cs = [], []
            for l in range(cfg.dec_layers):
                xg = jnp.dot(x, self.w_x[l],
                             preferred_element_type=jnp.float32) + self.b_x[l]
                h, c = lstm_cell_step(state["h"][l], state["c"][l], xg,
                                      self.w_h[l])
                hs.append(h)
                cs.append(c)
                x = h
            context, att_w = self._attend(hs[-1], enc, enc_proj, enc_mask,
                                          state["att_w"])
            outs.append(jnp.dot(jnp.concatenate([hs[-1], context], -1),
                                self.w_out,
                                preferred_element_type=jnp.float32)
                        + self.b_out)
            state = {"h": jnp.stack(hs), "c": jnp.stack(cs),
                     "att_w": att_w, "context": context}
        return jnp.stack(outs, axis=1)


class ASRModel(nn.Module):
    cfg: object
    vocab_size: int
    use_decoder: bool = True

    def setup(self):
        self.encoder = BiLSTMEncoder(self.cfg, self.vocab_size)
        if self.use_decoder:
            self.decoder = AttentionDecoder(self.cfg, self.vocab_size)

    def __call__(self, feats, feat_len, tokens_in=None):
        enc, enc_len, ctc_logits = self.encoder(feats, feat_len)
        out = {"enc": enc, "enc_len": enc_len, "ctc_logits": ctc_logits}
        if self.use_decoder and tokens_in is not None:
            out["att_logits"] = self.decoder(enc, enc_len, tokens_in)
        return out


class LSTMLM(nn.Module):
    vocab_size: int
    embed_dim: int = 256
    hidden: int = 512
    layers: int = 2

    def setup(self):
        V, E, H = self.vocab_size, self.embed_dim, self.hidden
        init = nn.initializers
        self.embed = self.param("embed", init.normal(1.0 / (E ** 0.5)), (V, E))
        in_dims = [E] + [H] * (self.layers - 1)
        self.w_x = [self.param(f"cell{l}_wx", init.lecun_normal(),
                               (in_dims[l], 4 * H))
                    for l in range(self.layers)]
        self.b_x = [self.param(f"cell{l}_b", init.zeros, (4 * H,))
                    for l in range(self.layers)]
        self.w_h = [self.param(f"cell{l}_wh", init.orthogonal(), (H, 4 * H))
                    for l in range(self.layers)]
        self.w_out = self.param("out_w", init.lecun_normal(), (H, V))
        self.b_out = self.param("out_b", init.zeros, (V,))

    def __call__(self, tokens_in, lens):
        x = self.embed[tokens_in]
        for l in range(self.layers):
            xg = jnp.dot(x, self.w_x[l],
                         preferred_element_type=jnp.float32) + self.b_x[l]
            x = lstm_scan(xg, lens, self.w_h[l])
        return jnp.dot(x, self.w_out,
                       preferred_element_type=jnp.float32) + self.b_out
