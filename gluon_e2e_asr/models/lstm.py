"""XLA-scanned LSTM primitives.

Reference-side realization: Gluon ``rnn.LSTM`` lowering to MXNet's C++
fused RNN operator (cuDNN/MKL-DNN) [SURVEY.md §2.1 #8, §2.2]. Here, as
prescribed by [BASELINE.json:L5]: "recurrent/attention encoder runs as
XLA-scanned layers".

Structure: the input projection for *all* timesteps is one large
[B*T, D] @ [D, 4H] matmul (done outside the scan);
``lax.scan`` then carries only the recurrent [B, H] @ [H, 4H] update.
Length masking freezes (h, c) past each sequence's end, which makes the
same kernel serve the reversed direction (state stays zero through the
pad region when scanning a flipped batch).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def lstm_cell_step(
    h: jnp.ndarray,  # [B, H]
    c: jnp.ndarray,  # [B, H]
    x_gates: jnp.ndarray,  # [B, 4H] = x_t @ W_x + b (precomputed)
    w_h: jnp.ndarray,  # [H, 4H]
    compute_dtype=jnp.float32,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One LSTM cell update. Gate order: (i, f, g, o); forget bias +1."""
    gates = x_gates + jnp.dot(
        h.astype(compute_dtype), w_h.astype(compute_dtype),
        preferred_element_type=jnp.float32,
    )
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    c_new = jax.nn.sigmoid(f + 1.0) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
    h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
    return h_new, c_new


def lstm_scan(
    x_gates: jnp.ndarray,  # [B, T, 4H] precomputed input projections
    lens: jnp.ndarray,  # [B]
    w_h: jnp.ndarray,  # [H, 4H]
    reverse: bool = False,
    compute_dtype=jnp.float32,
) -> jnp.ndarray:
    """Run an LSTM over time. Returns outputs [B, T, H]; padded steps emit
    zeros and do not perturb the carried state."""
    B, T, H4 = x_gates.shape
    H = H4 // 4
    valid = jnp.arange(T)[None, :] < lens[:, None]  # [B, T]
    xs = jnp.swapaxes(x_gates, 0, 1)  # [T, B, 4H]
    vs = valid.T  # [T, B]
    if reverse:
        xs = jnp.flip(xs, axis=0)
        vs = jnp.flip(vs, axis=0)

    def step(carry, inp):
        h, c = carry
        xg, v = inp
        h_new, c_new = lstm_cell_step(h, c, xg, w_h, compute_dtype)
        vm = v[:, None]
        h = jnp.where(vm, h_new, h)
        c = jnp.where(vm, c_new, c)
        out = jnp.where(vm, h_new, jnp.zeros_like(h_new))
        return (h, c), out

    init = (jnp.zeros((B, H), jnp.float32), jnp.zeros((B, H), jnp.float32))
    _, ys = jax.lax.scan(step, init, (xs, vs))
    if reverse:
        ys = jnp.flip(ys, axis=0)
    return jnp.swapaxes(ys, 0, 1)  # [B, T, H]


def bilstm_scan(
    x_gates_f: jnp.ndarray,  # [B, T, 4H] forward-direction input projections
    x_gates_b: jnp.ndarray,  # [B, T, 4H] backward-direction input projections
    lens: jnp.ndarray,  # [B]
    w_hf: jnp.ndarray,  # [H, 4H]
    w_hb: jnp.ndarray,  # [H, 4H]
    compute_dtype=jnp.float32,
) -> jnp.ndarray:
    """Both LSTM directions in ONE ``lax.scan``: the backward direction
    consumes time-flipped inputs, so each scan step updates a stacked
    [2, B, H] state with a single batched [2,B,H]x[2,H,4H] matmul. Halves
    the sequential loop count vs two separate scans (at small batch the
    per-iteration latency, not the matmul FLOPs, bounds an LSTM).

    Returns concat(fwd, bwd) outputs [B, T, 2H].
    """
    B, T, H4 = x_gates_f.shape
    H = H4 // 4
    valid = jnp.arange(T)[None, :] < lens[:, None]  # [B, T]
    xs_f = jnp.swapaxes(x_gates_f, 0, 1)  # [T, B, 4H]
    xs_b = jnp.flip(jnp.swapaxes(x_gates_b, 0, 1), axis=0)
    vs_f = valid.T  # [T, B]
    vs_b = jnp.flip(vs_f, axis=0)
    xs = jnp.stack([xs_f, xs_b], axis=1)  # [T, 2, B, 4H]
    vs = jnp.stack([vs_f, vs_b], axis=1)  # [T, 2, B]
    w = jnp.stack([w_hf, w_hb]).astype(compute_dtype)  # [2, H, 4H]

    def step(carry, inp):
        h, c = carry  # [2, B, H] each
        xg, v = inp  # [2, B, 4H], [2, B]
        gates = xg + jax.lax.dot_general(
            h.astype(compute_dtype), w,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        c_new = jax.nn.sigmoid(f + 1.0) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
        vm = v[..., None]
        h = jnp.where(vm, h_new, h)
        c = jnp.where(vm, c_new, c)
        out = jnp.where(vm, h_new, jnp.zeros_like(h_new))
        return (h, c), out

    init = (
        jnp.zeros((2, B, H), jnp.float32),
        jnp.zeros((2, B, H), jnp.float32),
    )
    _, ys = jax.lax.scan(step, init, (xs, vs))  # ys [T, 2, B, H]
    fwd = jnp.swapaxes(ys[:, 0], 0, 1)  # [B, T, H]
    bwd = jnp.swapaxes(jnp.flip(ys[:, 1], axis=0), 0, 1)
    return jnp.concatenate([fwd, bwd], axis=-1)  # [B, T, 2H]
