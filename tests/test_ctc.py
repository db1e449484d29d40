"""CTC loss correctness: brute-force enumeration, finite differences, and
optax cross-check [SURVEY.md §4 "Unit: CTC loss"]."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gluon_e2e_asr.ops.ctc import (
    ctc_forward_alpha,
    ctc_greedy_decode,
    ctc_loss,
)


def brute_force_ctc_nll(logp: np.ndarray, label: list, blank: int = 0) -> float:
    """Enumerate all alignment paths of length T; sum path probabilities
    whose collapse equals the label."""
    T, V = logp.shape

    def collapse(path):
        out, prev = [], blank
        for s in path:
            if s != blank and s != prev:
                out.append(s)
            prev = s
        return out

    total = -np.inf
    for path in itertools.product(range(V), repeat=T):
        if collapse(path) == list(label):
            lp = sum(logp[t, path[t]] for t in range(T))
            total = np.logaddexp(total, lp)
    return -total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vs_brute_force(seed):
    rng = np.random.RandomState(seed)
    T, V = 5, 4
    cases = [
        [1],
        [1, 2],
        [2, 2],  # repeated label needs a blank between
        [1, 2, 3],
        [],
    ]
    for label in cases:
        logits = rng.randn(1, T, V).astype(np.float32)
        logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
        want = brute_force_ctc_nll(logp[0], label)
        L = max(len(label), 1)
        labels = np.zeros((1, L), np.int32)
        labels[0, : len(label)] = label
        got = float(
            ctc_forward_alpha(
                jnp.asarray(logp),
                jnp.array([T], jnp.int32),
                jnp.asarray(labels),
                jnp.array([len(label)], jnp.int32),
            )[0]
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_vs_optax():
    rng = np.random.RandomState(42)
    B, T, V, L = 3, 12, 6, 4
    logits = rng.randn(B, T, V).astype(np.float32)
    labels = rng.randint(1, V, size=(B, L)).astype(np.int32)
    label_lens = np.array([4, 2, 3], np.int32)
    input_lens = np.array([12, 9, 7], np.int32)
    labels_masked = labels * (np.arange(L)[None] < label_lens[:, None])

    ours = ctc_loss(
        jnp.asarray(logits), jnp.asarray(input_lens),
        jnp.asarray(labels_masked), jnp.asarray(label_lens),
    )
    logit_pads = (np.arange(T)[None] >= input_lens[:, None]).astype(np.float32)
    label_pads = (np.arange(L)[None] >= label_lens[:, None]).astype(np.float32)
    ref = optax.ctc_loss(
        jnp.asarray(logits), jnp.asarray(logit_pads),
        jnp.asarray(labels_masked), jnp.asarray(label_pads),
    )
    # fp32 logsumexp accumulation differs slightly between implementations
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=2e-3,
                               atol=1e-3)


def test_grad_vs_finite_differences():
    rng = np.random.RandomState(7)
    T, V, L = 6, 4, 2
    logits = rng.randn(1, T, V).astype(np.float64).astype(np.float32)
    labels = np.array([[1, 3]], np.int32)

    @jax.jit
    def f(x):
        return ctc_loss(
            x, jnp.array([T], jnp.int32), jnp.asarray(labels),
            jnp.array([L], jnp.int32),
        ).sum()

    grad = np.asarray(jax.grad(f)(jnp.asarray(logits)))
    eps = 1e-3
    for t in range(T):
        for v in range(V):
            lp = logits.copy()
            lm = logits.copy()
            lp[0, t, v] += eps
            lm[0, t, v] -= eps
            fd = (float(f(jnp.asarray(lp))) - float(f(jnp.asarray(lm)))) / (2 * eps)
            np.testing.assert_allclose(grad[0, t, v], fd, rtol=2e-2, atol=2e-3)


@pytest.mark.slow
def test_grad_vs_optax_grad():
    rng = np.random.RandomState(3)
    B, T, V, L = 2, 10, 5, 3
    logits = jnp.asarray(rng.randn(B, T, V).astype(np.float32))
    labels = jnp.asarray(rng.randint(1, V, size=(B, L)).astype(np.int32))
    label_lens = jnp.array([3, 2], jnp.int32)
    input_lens = jnp.array([10, 6], jnp.int32)
    labels = labels * (jnp.arange(L)[None] < label_lens[:, None])

    g_ours = jax.grad(
        lambda x: ctc_loss(x, input_lens, labels, label_lens).sum()
    )(logits)
    logit_pads = (jnp.arange(T)[None] >= input_lens[:, None]).astype(jnp.float32)
    label_pads = (jnp.arange(L)[None] >= label_lens[:, None]).astype(jnp.float32)
    g_ref = jax.grad(
        lambda x: optax.ctc_loss(x, logit_pads, labels, label_pads).sum()
    )(logits)
    np.testing.assert_allclose(np.asarray(g_ours), np.asarray(g_ref),
                               rtol=1e-3, atol=1e-4)


def test_pad_rows_zero_loss_and_grad():
    B, T, V, L = 2, 8, 5, 3
    rng = np.random.RandomState(0)
    logits = jnp.asarray(rng.randn(B, T, V).astype(np.float32))
    labels = jnp.zeros((B, L), jnp.int32).at[0].set(jnp.array([1, 2, 3]))
    input_lens = jnp.array([8, 0], jnp.int32)
    label_lens = jnp.array([3, 0], jnp.int32)
    loss = ctc_loss(logits, input_lens, labels, label_lens)
    assert float(loss[1]) == 0.0
    g = jax.grad(lambda x: ctc_loss(x, input_lens, labels, label_lens).sum())(
        logits
    )
    np.testing.assert_array_equal(np.asarray(g[1]), 0.0)
    assert np.isfinite(np.asarray(g)).all()


def test_greedy_decode_collapse():
    # logits encoding path: blank,1,1,blank,2,2,blank -> [1,2]
    V = 4
    path = [0, 1, 1, 0, 2, 2, 0]
    logits = np.full((1, len(path), V), -10.0, np.float32)
    for t, s in enumerate(path):
        logits[0, t, s] = 10.0
    ids, lens = ctc_greedy_decode(jnp.asarray(logits),
                                  jnp.array([len(path)], jnp.int32))
    assert int(lens[0]) == 2
    assert np.asarray(ids)[0, :2].tolist() == [1, 2]


def test_greedy_decode_respects_length():
    V = 4
    path = [1, 0, 2, 3, 3]
    logits = np.full((1, len(path), V), -10.0, np.float32)
    for t, s in enumerate(path):
        logits[0, t, s] = 10.0
    ids, lens = ctc_greedy_decode(jnp.asarray(logits), jnp.array([3], jnp.int32))
    assert int(lens[0]) == 2
    assert np.asarray(ids)[0, :2].tolist() == [1, 2]
