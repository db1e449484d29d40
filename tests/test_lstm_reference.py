"""The scanned LSTM primitives (models/lstm.py) against references that
share no code with them: a NumPy step loop for the values, and a
Python-unrolled jnp loop for the gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.models.lstm import bilstm_scan, lstm_scan

LENS = {
    "full": [9, 9, 9],
    "ragged": [9, 5, 1],
    "empty_row": [7, 0, 3],
}


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def np_lstm(xg, lens, w_h, reverse):
    """Per-row step loop: gate order (i, f, g, o), forget bias +1. Each
    row runs over its own valid frames only (backwards from len-1 for the
    reverse direction); padded frames output zeros."""
    B, T, H4 = xg.shape
    H = H4 // 4
    out = np.zeros((B, T, H), np.float64)
    for b in range(B):
        h = np.zeros(H)
        c = np.zeros(H)
        steps = range(lens[b] - 1, -1, -1) if reverse else range(lens[b])
        for t in steps:
            g = xg[b, t] + h @ w_h
            i, f, gg, o = np.split(g, 4)
            c = _sigmoid(f + 1.0) * c + _sigmoid(i) * np.tanh(gg)
            h = _sigmoid(o) * np.tanh(c)
            out[b, t] = h
    return out


def _inputs(lens, H=8, seed=0):
    B, T = len(lens), 9
    rng = np.random.RandomState(seed)
    xg_f = rng.randn(B, T, 4 * H).astype(np.float32) * 0.5
    xg_b = rng.randn(B, T, 4 * H).astype(np.float32) * 0.5
    w_hf = rng.randn(H, 4 * H).astype(np.float32) * 0.2
    w_hb = rng.randn(H, 4 * H).astype(np.float32) * 0.2
    return xg_f, xg_b, w_hf, w_hb


def test_bilstm_scan_matches_two_scans():
    """Fused bidirectional scan == two separate directional scans."""
    xg_f, xg_b, w_hf, w_hb = map(jnp.asarray, _inputs(LENS["ragged"]))
    lens = jnp.asarray(LENS["ragged"], jnp.int32)
    fused = bilstm_scan(xg_f, xg_b, lens, w_hf, w_hb)
    fwd = lstm_scan(xg_f, lens, w_hf, reverse=False)
    bwd = lstm_scan(xg_b, lens, w_hb, reverse=True)
    ref = jnp.concatenate([fwd, bwd], axis=-1)
    np.testing.assert_allclose(np.asarray(fused), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(LENS))
def test_bilstm_scan_matches_numpy_step_loop(case):
    lens = LENS[case]
    xg_f, xg_b, w_hf, w_hb = _inputs(lens)
    got = np.asarray(bilstm_scan(
        jnp.asarray(xg_f), jnp.asarray(xg_b), jnp.asarray(lens, jnp.int32),
        jnp.asarray(w_hf), jnp.asarray(w_hb)))
    ref = np.concatenate([np_lstm(xg_f, lens, w_hf, reverse=False),
                          np_lstm(xg_b, lens, w_hb, reverse=True)], axis=-1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_numpy_step_loop(reverse):
    lens = LENS["ragged"]
    xg, _, w_h, _ = _inputs(lens, seed=1)
    got = np.asarray(lstm_scan(jnp.asarray(xg), jnp.asarray(lens, jnp.int32),
                               jnp.asarray(w_h), reverse=reverse))
    np.testing.assert_allclose(got, np_lstm(xg, lens, w_h, reverse),
                               rtol=1e-5, atol=1e-6)


def _unrolled_bilstm(xg_f, xg_b, lens, w_hf, w_hb):
    """Python-unrolled jnp reference (no lax.scan): per-row valid steps
    via masks, the same function bilstm_scan computes."""
    B, T, H4 = xg_f.shape
    H = H4 // 4
    outs = []
    for xg, w, rev in ((xg_f, w_hf, False), (xg_b, w_hb, True)):
        h = jnp.zeros((B, H))
        c = jnp.zeros((B, H))
        ys = [None] * T
        for t in (range(T - 1, -1, -1) if rev else range(T)):
            g = xg[:, t] + h @ w
            i, f, gg, o = jnp.split(g, 4, axis=-1)
            c_new = jax.nn.sigmoid(f + 1.0) * c + jax.nn.sigmoid(i) * jnp.tanh(gg)
            h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
            v = (t < lens)[:, None]
            h = jnp.where(v, h_new, h)
            c = jnp.where(v, c_new, c)
            ys[t] = jnp.where(v, h_new, 0.0)
        outs.append(jnp.stack(ys, axis=1))
    return jnp.concatenate(outs, axis=-1)


@pytest.mark.parametrize("case", ["full", "ragged"])
def test_bilstm_scan_gradient_matches_unrolled(case):
    lens = jnp.asarray(LENS[case], jnp.int32)
    args = tuple(map(jnp.asarray, _inputs(LENS[case], seed=2)))
    proj = jnp.asarray(np.random.RandomState(3).randn(len(LENS[case]), 9, 16),
                       jnp.float32)

    def loss(fn, xg_f, xg_b, w_hf, w_hb):
        return jnp.sum(fn(xg_f, xg_b, lens, w_hf, w_hb) * proj)

    g_scan = jax.grad(lambda *a: loss(bilstm_scan, *a), argnums=(0, 1, 2, 3))(
        *args)
    g_ref = jax.grad(lambda *a: loss(_unrolled_bilstm, *a),
                     argnums=(0, 1, 2, 3))(*args)
    for a, b in zip(g_scan, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
