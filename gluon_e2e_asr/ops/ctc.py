"""CTC loss as an on-device alpha-beta recursion with a custom VJP.

Reference-side realization: MXNet's native CTC operator (C++/CUDA,
warp-ctc lineage) [SURVEY.md §2.1 #9, §2.2]. Here, as prescribed by
[BASELINE.json:L5]: "CTC forward-backward ... run as on-device
alpha-beta recursion kernels".

Design [SURVEY.md §3.5]:
  * labels are expanded to the blank-interleaved state lattice
    [B, S=2L+1];
  * the alpha (forward) and beta (backward) recursions are log-space
    ``lax.scan``s over time, masked for ragged (T, L);
  * the gradient is computed analytically from the state posteriors
    (custom_vjp) instead of differentiating through the forward scan —
    this halves the recursion work under grad and avoids storing scan
    residuals: grad wrt logits = softmax(logits) - posterior;
  * the posterior's scatter over vocabulary is a one-hot matmul
    rather than a scatter.

Correctness is pinned in tests against brute-force alignment
enumeration, finite differences, and ``optax.ctc_loss``
[SURVEY.md §4 "Unit: CTC loss"].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def _expand_labels(labels: jnp.ndarray, blank_id: int) -> jnp.ndarray:
    """[B, L] -> blank-interleaved state labels [B, 2L+1]:
    (blank, l1, blank, l2, ..., lL, blank)."""
    B, L = labels.shape
    ext = jnp.full((B, 2 * L + 1), blank_id, labels.dtype)
    return ext.at[:, 1::2].set(labels)


def _transition_mask(ext_labels: jnp.ndarray, blank_id: int) -> jnp.ndarray:
    """allow_skip[b, s]: whether the s-2 -> s transition is legal
    (lab(s) != blank and lab(s) != lab(s-2))."""
    lab = ext_labels
    lab_m2 = jnp.pad(lab, ((0, 0), (2, 0)), constant_values=blank_id)[:, :-2]
    return (lab != blank_id) & (lab != lab_m2)


def _gather_states(logp: jnp.ndarray, ext: jnp.ndarray) -> jnp.ndarray:
    """[B,T,V] log-probs + [B,S] state labels -> [T,B,S] emissions,
    as a one-hot matmul (~30 M MACs at flagship shapes) instead of a
    [B,T,S] gather."""
    V = logp.shape[-1]
    onehot = jax.nn.one_hot(ext, V, dtype=logp.dtype)  # [B,S,V]
    return jnp.einsum("btv,bsv->tbs", logp, onehot)


def _alpha_scan(logp_states, time_mask, allow_skip, state_valid):
    """Forward recursion. logp_states: [T, B, S] log-prob of each state's
    emission at each time. Returns alpha [T, B, S] (log space)."""
    T, B, S = logp_states.shape
    init = jnp.full((B, S), NEG_INF)
    init = init.at[:, 0].set(0.0)  # before consuming t=0: mass at state 0

    # alpha_t = logsumexp(alpha_{t-1}[s], [s-1], [s-2 if allowed]) + emit_t
    def step(alpha, inp):
        emit, tmask = inp  # [B,S], [B]
        a0 = alpha
        a1 = jnp.pad(alpha, ((0, 0), (1, 0)), constant_values=NEG_INF)[:, :-1]
        a2 = jnp.pad(alpha, ((0, 0), (2, 0)), constant_values=NEG_INF)[:, :-2]
        a2 = jnp.where(allow_skip, a2, NEG_INF)
        m = jnp.maximum(jnp.maximum(a0, a1), a2)
        msafe = jnp.maximum(m, NEG_INF)  # avoid -inf - -inf
        new = msafe + jnp.log(
            jnp.exp(a0 - msafe) + jnp.exp(a1 - msafe) + jnp.exp(a2 - msafe)
        )
        new = new + emit
        new = jnp.where(state_valid, new, NEG_INF)
        new = jnp.where(tmask[:, None], new, alpha)  # freeze past seq end
        return new, new

    # First step is special: alpha_0[s] = emit_0[s] for s in {0,1}.
    def first(alpha, inp):
        emit, tmask = inp
        new = jnp.where(
            (jnp.arange(S)[None, :] <= 1) & state_valid, emit, NEG_INF
        )
        new = jnp.where(tmask[:, None], new, alpha)
        return new, new

    a0_new, _ = first(init, (logp_states[0], time_mask[0]))
    _, alphas = jax.lax.scan(step, a0_new, (logp_states[1:], time_mask[1:]))
    return jnp.concatenate([a0_new[None], alphas], axis=0)  # [T,B,S]


def _beta_scan(logp_states, time_mask, allow_skip_fwd, state_valid, last_state):
    """Backward recursion; beta[t,s] includes the emission at t.
    beta_t[s] = emit_t[s] + logsumexp(beta_{t+1}[s], [s+1], [s+2 if allowed])."""
    T, B, S = logp_states.shape
    # s -> s+2 is legal iff the forward skip into s+2 is legal.
    allow_fwd2 = jnp.pad(allow_skip_fwd, ((0, 0), (0, 2)))[:, 2:]  # [B,S]

    init = jnp.full((B, S), NEG_INF)  # beta after the last frame
    s_idx = jnp.arange(S)[None, :]
    # At the final valid frame t = T_b - 1, beta = emit (only last two states).
    final_ok = (s_idx == last_state[:, None]) | (s_idx == last_state[:, None] - 1)

    def step(beta, inp):
        emit, tmask, is_last = inp  # [B,S], [B], [B]
        b0 = beta
        b1 = jnp.pad(beta, ((0, 0), (0, 1)), constant_values=NEG_INF)[:, 1:]
        b2 = jnp.pad(beta, ((0, 0), (0, 2)), constant_values=NEG_INF)[:, 2:]
        b2 = jnp.where(allow_fwd2, b2, NEG_INF)
        m = jnp.maximum(jnp.maximum(b0, b1), b2)
        msafe = jnp.maximum(m, NEG_INF)
        acc = msafe + jnp.log(
            jnp.exp(b0 - msafe) + jnp.exp(b1 - msafe) + jnp.exp(b2 - msafe)
        )
        new = emit + acc
        # At each sample's last frame, restart: beta = emit on final states.
        new = jnp.where(is_last[:, None], jnp.where(final_ok, emit, NEG_INF), new)
        new = jnp.where(state_valid, new, NEG_INF)
        new = jnp.where(tmask[:, None], new, beta)  # beyond seq: untouched
        return new, new

    T_lens = time_mask.sum(axis=0)  # [B]
    t_idx = jnp.arange(T)
    is_last_mat = (t_idx[:, None] == (T_lens[None, :] - 1))  # [T,B]
    _, betas = jax.lax.scan(
        step,
        init,
        (logp_states[::-1], time_mask[::-1], is_last_mat[::-1]),
    )
    return betas[::-1]  # [T,B,S]


def ctc_forward_alpha(logp, input_lens, labels, label_lens, blank_id=0):
    """Forward pass only: per-sample negative log likelihood [B].
    ``logp`` are log-probabilities [B, T, V] (already log-softmaxed)."""
    B, T, V = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    ext = _expand_labels(labels, blank_id)  # [B,S]
    allow_skip = _transition_mask(ext, blank_id)
    state_valid = jnp.arange(S)[None, :] < (2 * label_lens + 1)[:, None]
    time_mask = (jnp.arange(T)[:, None] < input_lens[None, :])  # [T,B]

    logp_states = _gather_states(logp, ext)  # [T,B,S]

    alpha = _alpha_scan(logp_states, time_mask, allow_skip, state_valid)
    a_last = alpha[-1]  # [B,S] (frozen at each sample's last frame)
    last_state = 2 * label_lens  # [B]
    aL = jnp.take_along_axis(a_last, last_state[:, None], axis=1)[:, 0]
    aLm1 = jnp.take_along_axis(
        a_last, jnp.maximum(last_state - 1, 0)[:, None], axis=1
    )[:, 0]
    aLm1 = jnp.where(label_lens > 0, aLm1, NEG_INF)
    m = jnp.maximum(aL, aLm1)
    ll = m + jnp.log(jnp.exp(aL - m) + jnp.exp(aLm1 - m))
    return -ll  # [B]


def _feasible(input_lens, labels, label_lens, blank_id):
    """A CTC alignment exists iff T >= L + (# adjacent repeated labels):
    each repeat needs an interposed blank frame. Infeasible rows (e.g. a
    long transcript bucketed with short audio) would otherwise contribute
    ~1e30 loss and poison the batch via global-norm gradient clipping."""
    B, L = labels.shape
    pos = jnp.arange(1, L)[None, :]
    rep = (labels[:, 1:] == labels[:, :-1]) & (pos < label_lens[:, None])
    needed = label_lens + rep.sum(axis=1)
    return (input_lens > 0) & (input_lens >= needed)


@jax.custom_vjp
def ctc_loss(logits, input_lens, labels, label_lens, blank_id=0):
    """Per-sample CTC negative log likelihood [B] from raw logits
    [B, T, V]. Ragged time/label lengths handled by masking; rows with
    input_len == 0 or an infeasible (too-long) label sequence contribute
    exactly 0 loss and 0 gradient (like torch's zero_infinity)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = ctc_forward_alpha(logp, input_lens, labels, label_lens, blank_id)
    ok = _feasible(input_lens, labels, label_lens, blank_id)
    return jnp.where(ok, nll, 0.0)


def _ctc_fwd(logits, input_lens, labels, label_lens, blank_id=0):
    B, T, V = logits.shape
    L = labels.shape[1]
    S = 2 * L + 1
    logp = jax.nn.log_softmax(logits, axis=-1)
    ext = _expand_labels(labels, blank_id)
    allow_skip = _transition_mask(ext, blank_id)
    state_valid = jnp.arange(S)[None, :] < (2 * label_lens + 1)[:, None]
    time_mask = jnp.arange(T)[:, None] < input_lens[None, :]
    logp_states = _gather_states(logp, ext)
    alpha = _alpha_scan(logp_states, time_mask, allow_skip, state_valid)
    last_state = 2 * label_lens
    a_last = alpha[-1]
    aL = jnp.take_along_axis(a_last, last_state[:, None], axis=1)[:, 0]
    aLm1 = jnp.take_along_axis(
        a_last, jnp.maximum(last_state - 1, 0)[:, None], axis=1
    )[:, 0]
    aLm1 = jnp.where(label_lens > 0, aLm1, NEG_INF)
    m = jnp.maximum(aL, aLm1)
    ll = m + jnp.log(jnp.exp(aL - m) + jnp.exp(aLm1 - m))  # log p(l|x), [B]
    ok = _feasible(input_lens, labels, label_lens, blank_id)
    nll = jnp.where(ok, -ll, 0.0)
    # logits are recomputable from logp residency-wise; store logp only.
    residuals = (logp, alpha, ext, allow_skip, state_valid,
                 input_lens, label_lens, ll, ok, blank_id)
    return nll, residuals


def _ctc_bwd(residuals, g):
    (logp, alpha, ext, allow_skip, state_valid,
     input_lens, label_lens, ll, ok, blank_id) = residuals
    B, T, V = logp.shape
    S = alpha.shape[-1]
    time_mask = jnp.arange(T)[:, None] < input_lens[None, :]
    logp_states = _gather_states(logp, ext)
    beta = _beta_scan(logp_states, time_mask, allow_skip, state_valid,
                      2 * label_lens)
    # gamma[t,s] = alpha + beta - emit (emission counted once).
    gamma = alpha + beta - logp_states  # [T,B,S]
    # Posterior over states normalized by likelihood: exp(gamma - ll).
    post_states = jnp.exp(
        jnp.clip(gamma - ll[None, :, None], min=2 * NEG_INF, max=0.0)
    )
    post_states = jnp.where(state_valid[None], post_states, 0.0)
    post_states = jnp.where(time_mask[:, :, None], post_states, 0.0)
    # Scatter states -> vocab via one-hot matmul [module docstring].
    onehot = jax.nn.one_hot(ext, V, dtype=post_states.dtype)  # [B,S,V]
    posterior = jnp.einsum("tbs,bsv->btv", post_states, onehot)  # [B,T,V]
    y = jnp.exp(logp)
    grad_logits = (y - posterior) * time_mask.T[:, :, None]
    grad_logits = grad_logits * jnp.where(ok, 1.0, 0.0)[:, None, None]
    grad_logits = grad_logits * g[:, None, None]
    return grad_logits, None, None, None, None


ctc_loss.defvjp(_ctc_fwd, _ctc_bwd)


def ctc_viterbi_align(logp, input_lens, labels, label_lens, blank_id=0):
    """CTC forced alignment: the single most likely frame↔state path.

    Same lattice as the loss (blank-interleaved states [B, S=2L+1]);
    the recursion is the alpha scan with max in place of logsumexp,
    recording the argmax predecessor (0/1/2 = stay/advance/skip) per
    state, then a reverse scan backtraces the best path — all on
    device, jit-friendly (static shapes, two ``lax.scan``s).

    Returns ``(states [B, T] int32, score [B])``: ``states[b, t]`` is
    the lattice state occupied at frame t (odd state 2k+1 = emitting
    token k, even = blank; -1 past ``input_lens[b]`` or for infeasible
    rows, whose score is NEG_INF). ``score`` is the log-probability of
    the best alignment. ``logp`` must be log-softmaxed [B, T, V].
    """
    B, T, V = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    ext = _expand_labels(labels, blank_id)
    allow_skip = _transition_mask(ext, blank_id)
    state_valid = jnp.arange(S)[None, :] < (2 * label_lens + 1)[:, None]
    time_mask = jnp.arange(T)[:, None] < input_lens[None, :]  # [T,B]
    # Exact gather (take_along_axis), NOT the one-hot einsum the loss
    # uses: at default matmul precision the einsum may round emissions
    # (TF32 on the GPU), and argmax backtrace is tie-sensitive — near-tie paths
    # could flip with precision settings. Alignment batches are small;
    # the gather's cost is negligible here.
    logp_states = jnp.transpose(
        jnp.take_along_axis(logp, ext[:, None, :], axis=2), (1, 0, 2)
    )  # [T,B,S]

    init = jnp.where(
        (jnp.arange(S)[None, :] <= 1) & state_valid,
        logp_states[0], NEG_INF)  # delta_0
    init = jnp.where(time_mask[0][:, None], init, NEG_INF)

    def step(delta, inp):
        emit, tmask = inp
        d1 = jnp.pad(delta, ((0, 0), (1, 0)), constant_values=NEG_INF)[:, :-1]
        d2 = jnp.pad(delta, ((0, 0), (2, 0)), constant_values=NEG_INF)[:, :-2]
        d2 = jnp.where(allow_skip, d2, NEG_INF)
        stacked = jnp.stack([delta, d1, d2], axis=0)  # [3,B,S]
        choice = jnp.argmax(stacked, axis=0).astype(jnp.int8)
        best = jnp.max(stacked, axis=0)
        new = jnp.where(state_valid, best + emit, NEG_INF)
        new = jnp.where(tmask[:, None], new, delta)  # freeze past seq end
        return new, choice

    delta_last, choices = jax.lax.scan(
        step, init, (logp_states[1:], time_mask[1:]))
    # choices[t-1] aligns with frame t (t in 1..T-1).
    choices = jnp.concatenate(
        [jnp.zeros((1, B, S), jnp.int8), choices], axis=0)  # [T,B,S]

    last_state = 2 * label_lens  # [B]
    dL = jnp.take_along_axis(delta_last, last_state[:, None], axis=1)[:, 0]
    dLm1 = jnp.take_along_axis(
        delta_last, jnp.maximum(last_state - 1, 0)[:, None], axis=1)[:, 0]
    dLm1 = jnp.where(label_lens > 0, dLm1, NEG_INF)
    score = jnp.maximum(dL, dLm1)
    s_fin = jnp.where(dL >= dLm1, last_state,
                      jnp.maximum(last_state - 1, 0)).astype(jnp.int32)

    lens = input_lens.astype(jnp.int32)

    def bt_step(s, inp):
        choice_t, t = inp  # [B,S], scalar
        is_last = t == lens - 1
        s = jnp.where(is_last, s_fin, s)
        active = t < lens
        out = jnp.where(active, s, -1)
        ch = jnp.take_along_axis(
            choice_t, jnp.maximum(s, 0)[:, None], axis=1)[:, 0]
        s = jnp.where(active & (t > 0), s - ch.astype(jnp.int32), s)
        return s, out

    _, states_rev = jax.lax.scan(
        bt_step, jnp.zeros((B,), jnp.int32),
        (choices[::-1], jnp.arange(T - 1, -1, -1)))
    states = states_rev[::-1].T  # [B,T]
    ok = _feasible(input_lens, labels, label_lens, blank_id) & (
        label_lens >= 0)
    states = jnp.where(ok[:, None], states, -1)
    score = jnp.where(ok, score, NEG_INF)
    return states.astype(jnp.int32), score


def spans_from_states(states_row, tokens, sec_per_frame: float):
    """Host-side: a Viterbi state row [T] (ctc_viterbi_align output) ->
    per-token {token, start_s, end_s} spans. Token k emits on lattice
    state 2k+1; a token absorbed into a skip transition gets None."""
    import numpy as np  # host-only helper

    states_row = np.asarray(states_row)
    spans = []
    for k, tok in enumerate(tokens):
        frames = np.nonzero(states_row == 2 * k + 1)[0]
        if len(frames) == 0:
            spans.append({"token": tok, "start_s": None, "end_s": None})
            continue
        spans.append({
            "token": tok,
            "start_s": round(float(frames[0]) * sec_per_frame, 4),
            "end_s": round(float(frames[-1] + 1) * sec_per_frame, 4),
        })
    return spans


def ctc_greedy_decode(logits: jnp.ndarray, input_lens: jnp.ndarray,
                      blank_id: int = 0):
    """Greedy CTC decode [BASELINE.json:L7]: framewise argmax; repeats and
    blanks are collapsed on device. Returns (ids [B, T], lengths [B]) where
    each row holds the collapsed symbols left-justified, padded with blank."""
    B, T, V = logits.shape
    best = jnp.argmax(logits, axis=-1)  # [B,T]
    prev = jnp.pad(best, ((0, 0), (1, 0)), constant_values=blank_id)[:, :-1]
    tmask = jnp.arange(T)[None, :] < input_lens[:, None]
    keep = (best != blank_id) & (best != prev) & tmask  # [B,T]
    # Left-justify kept symbols: position = cumsum(keep) - 1.
    pos = jnp.cumsum(keep, axis=1) - 1
    out_len = keep.sum(axis=1).astype(jnp.int32)
    out = jnp.full((B, T), blank_id, best.dtype)
    bidx = jnp.arange(B)[:, None]
    safe_pos = jnp.where(keep, pos, T - 1)
    # scatter: out[b, pos] = best where keep (later writes at T-1 are
    # overwritten only by other discarded values; mask below fixes them)
    out = out.at[bidx, safe_pos].set(jnp.where(keep, best, blank_id))
    valid = jnp.arange(T)[None, :] < out_len[:, None]
    out = jnp.where(valid, out, blank_id)
    return out, out_len
