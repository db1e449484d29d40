"""CTC Viterbi forced alignment (ops/ctc.py::ctc_viterbi_align)
[SURVEY.md §2.1 #9 CTC machinery; the alignment surface of the same
lattice the loss uses]."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.ops.ctc import (
    _expand_labels,
    ctc_forward_alpha,
    ctc_viterbi_align,
)


def _brute_force_best_path(logp_row, T_len, labels_row, L_len, blank=0):
    """Enumerate every legal CTC state path; return (best score, path)."""
    labels = list(labels_row[:L_len])
    S = 2 * L_len + 1
    ext = [blank] * S
    ext[1::2] = labels

    def succ(s):
        nxt = [s, s + 1]
        if (s + 2 < S and ext[s + 2] != blank
                and (s < 1 or True) and ext[s + 2] != ext[s]):
            nxt.append(s + 2)
        return [x for x in nxt if x < S]

    best = (-np.inf, None)
    frontier = {(0,): logp_row[0][ext[0]], (1,): logp_row[0][ext[1]]} \
        if S > 1 else {(0,): logp_row[0][ext[0]]}
    for t in range(1, T_len):
        new = {}
        for path, sc in frontier.items():
            for s2 in succ(path[-1]):
                p2 = path + (s2,)
                sc2 = sc + logp_row[t][ext[s2]]
                if sc2 > new.get(p2, -np.inf):
                    new[p2] = sc2
        frontier = new
    for path, sc in frontier.items():
        if path[-1] in (S - 1, S - 2) and sc > best[0]:
            best = (sc, path)
    return best


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_matches_brute_force(seed):
    rng = np.random.RandomState(seed)
    B, T, V, L = 3, 6, 5, 2
    logits = rng.randn(B, T, V).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = rng.randint(1, V, (B, L)).astype(np.int32)
    label_lens = np.array([2, 1, 2], np.int32)
    input_lens = np.array([6, 4, 5], np.int32)
    states, score = ctc_viterbi_align(
        jnp.asarray(logp), jnp.asarray(input_lens),
        jnp.asarray(labels), jnp.asarray(label_lens))
    states, score = np.asarray(states), np.asarray(score)
    for b in range(B):
        want_sc, want_path = _brute_force_best_path(
            logp[b], int(input_lens[b]), labels[b], int(label_lens[b]))
        np.testing.assert_allclose(score[b], want_sc, rtol=1e-5)
        got_path = tuple(states[b, :input_lens[b]])
        # score ties can pick a different argmax path; verify the score
        # of the returned path equals the optimum instead
        ext = _expand_labels(jnp.asarray(labels[b:b + 1]), 0)[0]
        path_sc = sum(
            logp[b, t, int(ext[s])] for t, s in enumerate(got_path))
        np.testing.assert_allclose(path_sc, want_sc, rtol=1e-5)
        # path legality: starts at state 0/1, ends at final two states,
        # steps forward by 0/1/2
        assert got_path[0] in (0, 1)
        assert got_path[-1] in (2 * label_lens[b], 2 * label_lens[b] - 1)
        for a, c in zip(got_path, got_path[1:]):
            assert c - a in (0, 1, 2)
    # pad frames are -1
    assert (states[1, input_lens[1]:] == -1).all()


def test_viterbi_score_bounded_by_total_likelihood():
    """max-path log-prob <= log p(l|x) (the sum over all paths)."""
    rng = np.random.RandomState(3)
    B, T, V, L = 4, 8, 6, 3
    logp = np.asarray(jax.nn.log_softmax(
        jnp.asarray(rng.randn(B, T, V).astype(np.float32)), axis=-1))
    labels = rng.randint(1, V, (B, L)).astype(np.int32)
    label_lens = np.array([3, 2, 3, 1], np.int32)
    input_lens = np.array([8, 8, 6, 5], np.int32)
    _, score = ctc_viterbi_align(
        jnp.asarray(logp), jnp.asarray(input_lens),
        jnp.asarray(labels), jnp.asarray(label_lens))
    nll = ctc_forward_alpha(
        jnp.asarray(logp), jnp.asarray(input_lens),
        jnp.asarray(labels), jnp.asarray(label_lens))
    assert (np.asarray(score) <= -np.asarray(nll) + 1e-4).all()


def test_viterbi_infeasible_row():
    """T < needed frames -> states -1, score NEG_INF; batch unharmed."""
    logp = np.asarray(jax.nn.log_softmax(
        jnp.zeros((2, 3, 4), jnp.float32), axis=-1))
    labels = np.array([[1, 1, 2], [1, 0, 0]], np.int32)  # row0 needs >=4
    states, score = ctc_viterbi_align(
        jnp.asarray(logp), jnp.asarray([3, 3], np.int32),
        jnp.asarray(labels), jnp.asarray([3, 1], np.int32))
    assert (np.asarray(states)[0] == -1).all()
    assert float(score[0]) < -1e20
    assert float(score[1]) > -1e3
    assert (np.asarray(states)[1] >= 0).all()


def test_viterbi_on_peaked_posteriors_recovers_segmentation():
    """With near-one-hot emissions the alignment must follow them."""
    V, blank = 5, 0
    # frames: a a _ b b b  (tokens a=2, b=3)
    seq = [2, 2, blank, 3, 3, 3]
    logits = np.full((1, 6, V), -10.0, np.float32)
    for t, v in enumerate(seq):
        logits[0, t, v] = 10.0
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    states, _ = ctc_viterbi_align(
        jnp.asarray(logp), jnp.asarray([6], np.int32),
        jnp.asarray([[2, 3]], np.int32), jnp.asarray([2], np.int32))
    got = list(np.asarray(states)[0])
    # state 1 = token 'a', state 2 = blank, state 3 = token 'b'
    assert got == [1, 1, 2, 3, 3, 3]


def test_viterbi_is_jittable():
    f = jax.jit(ctc_viterbi_align)
    logp = jax.nn.log_softmax(jnp.zeros((2, 5, 4)), axis=-1)
    states, score = f(logp, jnp.asarray([5, 4]),
                      jnp.asarray([[1, 2], [3, 0]]), jnp.asarray([2, 1]))
    assert states.shape == (2, 5)
    assert np.isfinite(np.asarray(score)).all()
