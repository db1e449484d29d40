"""The jitted training step: frontend -> encoder -> losses -> update.

One XLA program per bucket shape [SURVEY.md §3.1]: everything from
feature extraction through the optax update (including the DP gradient
allreduce) compiles into a single program
[BASELINE.json:L5,L10].
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gluon_e2e_asr.config import Config
from gluon_e2e_asr.frontend.features import frontend_apply
from gluon_e2e_asr.models.asr import ASRModel
from gluon_e2e_asr.ops.ctc import ctc_loss
from gluon_e2e_asr.ops.losses import (
    ce_label_smoothing_loss,
    hybrid_loss,
    make_decoder_io,
)
from gluon_e2e_asr.parallel.mesh import batch_sharding, replicated_sharding


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["step", "params", "opt_state", "rng"],
                   meta_fields=[])
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray  # scalar int32
    params: Any
    opt_state: Any
    rng: jax.Array

    def replace(self, **updates) -> "TrainState":
        return dataclasses.replace(self, **updates)


def make_optimizer(config: Config) -> optax.GradientTransformation:
    """optax chain: global-norm clip + Adam/SGD + warmup->inverse-sqrt LR
    [SURVEY.md §2.1 #14]."""
    tc = config.train
    if tc.warmup_steps > 0:
        sched = optax.join_schedules(
            [
                optax.linear_schedule(0.0, tc.learning_rate, tc.warmup_steps),
                lambda s: tc.learning_rate
                * jnp.sqrt(tc.warmup_steps / jnp.maximum(s + tc.warmup_steps, 1)),
            ],
            [tc.warmup_steps],
        )
    else:
        sched = tc.learning_rate
    if tc.optimizer in ("adam", "adamw"):
        # weight_decay=0.0 (the default) makes this exactly plain Adam;
        # nonzero decay is decoupled (AdamW) — see config.py optimizer doc.
        opt = optax.adamw(sched, weight_decay=tc.weight_decay)
    elif tc.optimizer == "sgd":
        opt = optax.sgd(sched, momentum=0.9)
    elif tc.optimizer == "adadelta":
        # The reference family's classic RNN-ASR optimizer. Wrapped in
        # inject_hyperparams so eps lives in the optimizer STATE: the
        # trainer's plateau annealing (train.eps_decay) mutates it
        # between epochs, and checkpoints carry the annealed value
        # through resume (see decay_opt_eps).
        opt = optax.inject_hyperparams(optax.adadelta)(
            learning_rate=sched, rho=tc.adadelta_rho, eps=tc.adadelta_eps)
    else:
        raise ValueError(f"unknown optimizer {tc.optimizer}")
    parts = []
    if tc.grad_clip_norm > 0:
        parts.append(optax.clip_by_global_norm(tc.grad_clip_norm))
    parts.append(opt)
    return optax.chain(*parts)


def create_train_state(
    config: Config,
    model: ASRModel,
    tx: optax.GradientTransformation,
    sample_batch: Dict[str, Any],
    cmvn_stats=None,
) -> TrainState:
    """Initialize params with a representative (bucket-shaped) batch."""
    root = jax.random.PRNGKey(config.train.seed)
    init_rng, state_rng = jax.random.split(root)

    feats, feat_len = frontend_apply(
        config.frontend,
        jnp.asarray(sample_batch["audio"]),
        jnp.asarray(sample_batch["audio_len"]),
        train=False,
        cmvn_stats=cmvn_stats,
    )
    tokens_in = None
    if model.use_decoder:
        tokens_in, _, _ = make_decoder_io(
            jnp.asarray(sample_batch["labels"]),
            jnp.asarray(sample_batch["label_len"]),
            model.sos_id,
            model.eos_id,
        )
    variables = model.init(init_rng, feats, feat_len, tokens_in)
    params = variables["params"]
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=tx.init(params),
        rng=state_rng,
    )


def create_template_state(
    config: Config,
    model: ASRModel,
    tx: optax.GradientTransformation,
    sample_batch: Dict[str, Any],
) -> TrainState:
    """Abstract-eval twin of ``create_train_state``: the same pytree
    structure with ShapeDtypeStruct leaves, built WITHOUT compiling or
    touching the device. Used as the restore template for checkpoints
    (restoring only needs structure), so the decode CLI skips the init
    compile."""
    root = jax.random.PRNGKey(config.train.seed)
    init_rng, state_rng = jax.random.split(root)

    def init_fn():
        # Global-CMVN configs need stats to trace the frontend; the
        # template only needs SHAPES, so zeros/ones placeholders are
        # exact (found by the rehearsal: decode at frontend.cmvn=global
        # asserted here before the checkpoint's real stats were read).
        stats = None
        if config.frontend.cmvn == "global":
            D = config.frontend.n_mels
            stats = (jnp.zeros((D,), jnp.float32),
                     jnp.ones((D,), jnp.float32))
        feats, feat_len = frontend_apply(
            config.frontend,
            jnp.zeros_like(jnp.asarray(sample_batch["audio"])),
            jnp.asarray(sample_batch["audio_len"]),
            train=False,
            cmvn_stats=stats,
        )
        tokens_in = None
        if model.use_decoder:
            tokens_in, _, _ = make_decoder_io(
                jnp.asarray(sample_batch["labels"]),
                jnp.asarray(sample_batch["label_len"]),
                model.sos_id,
                model.eos_id,
            )
        return model.init(init_rng, feats, feat_len, tokens_in)

    variables = jax.eval_shape(init_fn)
    params = variables["params"]
    opt_state = jax.eval_shape(tx.init, params)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=opt_state,
        rng=state_rng,
    )


def compute_loss(
    params,
    batch: Dict[str, jnp.ndarray],
    rng: jax.Array,
    *,
    model: ASRModel,
    config: Config,
    cmvn_stats=None,
    train: bool = True,
    axis_name: Optional[str] = None,
    step: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Full forward + hybrid loss [SURVEY.md §3.1 inner stack].

    Under shard_map (``axis_name`` set) the batch is the LOCAL shard; the
    loss is normalized by the GLOBAL real-row count (psum) so that
    psum-of-gradients reproduces single-device gradients exactly.

    ``step`` (traced scalar, the optimizer step) drives the scheduled
    sampling ratio ramp [SURVEY.md §2.1 #12].
    """
    k_spec, k_ss, k_drop = jax.random.split(rng, 3)
    feats, feat_len = frontend_apply(
        config.frontend,
        batch["audio"],
        batch["audio_len"],
        train=train,
        rng=k_spec,
        cmvn_stats=cmvn_stats,
    )
    mtl_alpha = config.loss.mtl_alpha
    labels = batch["labels"]
    label_len = batch["label_len"]
    num_real = (batch["audio_len"] > 0).sum()
    if axis_name is not None:
        num_real = jax.lax.psum(num_real, axis_name)

    tokens_in = None
    if model.use_decoder:
        tokens_in, targets, tgt_mask = make_decoder_io(
            labels, label_len, model.sos_id, model.eos_id
        )
    ss_prob = config.loss.scheduled_sampling if train else 0.0
    warmup = config.loss.scheduled_sampling_warmup_steps
    if train and ss_prob > 0.0 and warmup > 0 and step is not None:
        # Linear sampling-ratio ramp 0 -> scheduled_sampling over `warmup`
        # optimizer steps (traced: one compiled program serves all steps).
        ss_prob = ss_prob * jnp.minimum(
            step.astype(jnp.float32) / float(warmup), 1.0)
    out = model.apply(
        {"params": params},
        feats,
        feat_len,
        tokens_in,
        ss_prob,
        k_ss,
        train=train,
        dropout_rng=k_drop,
    )
    if mtl_alpha > 0.0:
        ctc_nll = ctc_loss(
            out["ctc_logits"], out["enc_len"], labels, label_len, blank_id=0
        )
    else:
        ctc_nll = jnp.zeros((labels.shape[0],), jnp.float32)
    att_acc = jnp.zeros(())
    if model.use_decoder:
        # Mask pad rows out of the attention CE.
        row_mask = (batch["audio_len"] > 0).astype(jnp.float32)[:, None]
        att_ce, acc = ce_label_smoothing_loss(
            out["att_logits"], targets, tgt_mask * row_mask,
            config.loss.label_smoothing,
        )
        acc_num = (acc * row_mask[:, 0]).sum()
        acc_den = row_mask.sum()
        if axis_name is not None:
            acc_num = jax.lax.psum(acc_num, axis_name)
            acc_den = jax.lax.psum(acc_den, axis_name)
        att_acc = acc_num / jnp.maximum(acc_den, 1.0)
    else:
        att_ce = jnp.zeros_like(ctc_nll)
    parts = hybrid_loss(ctc_nll, att_ce, label_len, mtl_alpha, num_real)
    metrics = dict(parts)
    metrics["att_acc"] = att_acc
    metrics["num_real"] = num_real
    return parts["loss"], metrics


def make_train_step(
    model: ASRModel,
    config: Config,
    tx: optax.GradientTransformation,
    mesh=None,
    cmvn_stats=None,
):
    """Build the jitted train step. With a mesh, the batch arrives sharded
    over the ``data`` axis and params replicated; XLA hands the gradient
    allreduce to the collective library (NCCL on GPUs) [BASELINE.json:L10].
    Two DP mechanisms
    (``config.train.dp_impl``):

    * ``shard_map`` (default) — the step body runs as an explicit
      per-shard program: the local shard computes local grads (loss
      normalized by the psum'd GLOBAL real-row count inside
      ``compute_loss``), then ``psum(grads)`` reproduces single-device
      gradients exactly. Per-shard PRNG: the step key is
      ``fold_in``-ed with ``axis_index('data')`` so SpecAugment /
      dropout / scheduled-sampling draws differ per shard (no key
      reuse across shards [SURVEY.md §5 race-detection analogue]).
    * ``pjit`` — sharding annotations on a global-view program; XLA
      chooses the partitioning and inserts the allreduce.
    """

    def step_fn(state: TrainState, batch: Dict[str, jnp.ndarray],
                axis_name: Optional[str] = None):
        new_rng, step_rng = jax.random.split(state.rng)
        if axis_name is not None:
            step_rng = jax.random.fold_in(
                step_rng, jax.lax.axis_index(axis_name)
            )
        grad_fn = jax.value_and_grad(compute_loss, has_aux=True)
        (_, metrics), grads = grad_fn(
            state.params,
            batch,
            step_rng,
            model=model,
            config=config,
            cmvn_stats=cmvn_stats,
            train=True,
            axis_name=axis_name,
            step=state.step,
        )
        if axis_name is not None:
            grads = jax.lax.psum(grads, axis_name)
            # Loss parts are local partial sums over a GLOBAL denominator
            # (compute_loss psums num_real); summing shards yields the
            # global means.
            for k in ("loss", "loss_ctc", "loss_att"):
                metrics[k] = jax.lax.psum(metrics[k], axis_name)
        grad_norm = optax.global_norm(grads)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics["grad_norm"] = grad_norm
        new_state = TrainState(
            step=state.step + 1,
            params=new_params,
            opt_state=new_opt,
            rng=new_rng,
        )
        return new_state, metrics

    if mesh is not None and config.train.dp_impl == "shard_map":
        from jax.sharding import PartitionSpec as P

        from gluon_e2e_asr.parallel.mesh import DATA_AXIS

        data_spec = P(DATA_AXIS)
        batch_specs = {
            "audio": data_spec, "audio_len": data_spec,
            "labels": data_spec, "label_len": data_spec,
        }
        # check_vma=False: the scan carries (LSTM/decoder/CTC) initialize
        # as unvarying zeros and become data-varying on the first step,
        # which the vma checker rejects; replication of the outputs is
        # guaranteed manually (psum'd grads -> identical update on every
        # shard) and verified by the DP-equality tests.
        sharded_fn = jax.shard_map(
            functools.partial(step_fn, axis_name=DATA_AXIS),
            mesh=mesh,
            in_specs=(P(), batch_specs),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return jax.jit(sharded_fn, donate_argnums=(0,))

    if mesh is not None:
        repl = replicated_sharding(mesh)
        data = batch_sharding(mesh)
        batch_shardings = {
            "audio": data, "audio_len": data, "labels": data, "label_len": data,
        }
        return jax.jit(
            step_fn,
            in_shardings=(repl, batch_shardings),
            out_shardings=(repl, repl),
            donate_argnums=(0,),
        )
    return jax.jit(step_fn, donate_argnums=(0,))


def make_grad_step(
    model: ASRModel,
    config: Config,
    mesh=None,
    cmvn_stats=None,
):
    """Micro-batch half of gradient accumulation [SURVEY.md §2.1 #14; the
    reference family's ``accum_grad`` knob — train.accum_grad_steps].

    Returns a jitted ``(state, batch) -> (state, grads, metrics)`` where
    ``grads`` are the micro-batch gradients WEIGHTED by its (global)
    real-row count and ``state`` only advances the PRNG — the optimizer
    step is applied separately by :func:`make_apply_step`. Because
    ``compute_loss`` is a mean over real rows, ``sum_i(n_i * g_i) /
    sum_i(n_i)`` reproduces the gradient of one combined batch exactly
    (up to float summation order). DP mirrors ``make_train_step``:
    psum'd grads/metrics, per-shard PRNG."""

    def grad_fn(state: TrainState, batch: Dict[str, jnp.ndarray],
                axis_name: Optional[str] = None):
        new_rng, step_rng = jax.random.split(state.rng)
        if axis_name is not None:
            step_rng = jax.random.fold_in(
                step_rng, jax.lax.axis_index(axis_name)
            )
        (_, metrics), grads = jax.value_and_grad(
            compute_loss, has_aux=True)(
            state.params,
            batch,
            step_rng,
            model=model,
            config=config,
            cmvn_stats=cmvn_stats,
            train=True,
            axis_name=axis_name,
            step=state.step,
        )
        if axis_name is not None:
            grads = jax.lax.psum(grads, axis_name)
            for k in ("loss", "loss_ctc", "loss_att"):
                metrics[k] = jax.lax.psum(metrics[k], axis_name)
        n = jnp.maximum(metrics["num_real"].astype(jnp.float32), 1.0)
        grads = jax.tree.map(lambda g: g * n, grads)
        new_state = state.replace(rng=new_rng)
        return new_state, grads, metrics

    if mesh is not None and config.train.dp_impl == "shard_map":
        from jax.sharding import PartitionSpec as P

        from gluon_e2e_asr.parallel.mesh import DATA_AXIS

        data_spec = P(DATA_AXIS)
        batch_specs = {
            "audio": data_spec, "audio_len": data_spec,
            "labels": data_spec, "label_len": data_spec,
        }
        sharded_fn = jax.shard_map(
            functools.partial(grad_fn, axis_name=DATA_AXIS),
            mesh=mesh,
            in_specs=(P(), batch_specs),
            out_specs=(P(), P(), P()),
            check_vma=False,  # see make_train_step
        )
        return jax.jit(sharded_fn, donate_argnums=(0,))

    if mesh is not None:
        repl = replicated_sharding(mesh)
        data = batch_sharding(mesh)
        batch_shardings = {
            "audio": data, "audio_len": data, "labels": data, "label_len": data,
        }
        return jax.jit(
            grad_fn,
            in_shardings=(repl, batch_shardings),
            out_shardings=(repl, repl, repl),
            donate_argnums=(0,),
        )
    return jax.jit(grad_fn, donate_argnums=(0,))


def make_apply_step(tx: optax.GradientTransformation):
    """Optimizer half of gradient accumulation: divide the accumulated
    num_real-weighted gradient sum by the total real-row count and take
    one optax update (clip included — it sees the combined-batch mean
    gradient, matching the unaccumulated step's clipping point)."""

    def apply_fn(state: TrainState, grads, total_n):
        scale = 1.0 / jnp.maximum(total_n.astype(jnp.float32), 1.0)
        grads = jax.tree.map(lambda g: g * scale, grads)
        grad_norm = optax.global_norm(grads)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            step=state.step + 1,
            params=new_params,
            opt_state=new_opt,
            rng=state.rng,
        )
        return new_state, grad_norm

    return jax.jit(apply_fn, donate_argnums=(0, 1))


# On-device pytree accumulate for gradient accumulation (donates the old
# accumulator: no device-memory growth across micro-batches).
accumulate_grads = jax.jit(
    lambda acc, g: jax.tree.map(jnp.add, acc, g), donate_argnums=(0,))


def decay_opt_eps(opt_state, factor: float):
    """Multiply every injected ``eps`` hyperparameter in ``opt_state`` by
    ``factor`` (the reference family's criterion-based adadelta
    annealing, train.eps_decay). Returns ``(new_opt_state, old_eps,
    new_eps)`` — the eps values are host floats for logging — or
    ``(opt_state, None, None)`` when no injected eps exists (e.g. the
    optimizer is adam/sgd, which are not inject-wrapped).

    The decayed value is floored at float32 tiny: repeated annealing
    would otherwise underflow eps to exactly 0, after which adadelta's
    ``sqrt(acc + eps)`` turns 0/0 on any zero-accumulator coordinate —
    measured as a mid-training NaN on a pathological every-epoch-decay
    run (BASELINE.md round-2 recipe-knob soaks)."""
    seen = []
    floor = float(np.finfo(np.float32).tiny)

    def walk(s):
        if isinstance(s, optax.InjectStatefulHyperparamsState) or (
                hasattr(s, "hyperparams") and hasattr(s, "_replace")):
            hp = dict(s.hyperparams)
            if "eps" in hp:
                old = jnp.asarray(hp["eps"])
                new = jnp.maximum(
                    old.astype(jnp.float32) * factor, floor
                ).astype(old.dtype)
                hp["eps"] = new
                seen.append((float(old), float(new)))
                return s._replace(hyperparams=hp)
            return s
        if isinstance(s, tuple):
            items = [walk(x) for x in s]
            return type(s)(*items) if hasattr(s, "_fields") else tuple(items)
        return s

    new_state = walk(opt_state)
    if not seen:
        return opt_state, None, None
    return new_state, seen[0][0], seen[0][1]


def make_eval_loss_step(model: ASRModel, config: Config, cmvn_stats=None):
    """Jitted dev-loss pass (no SpecAugment / dropout / scheduled sampling)."""

    def eval_fn(params, batch, rng):
        _, metrics = compute_loss(
            params, batch, rng, model=model, config=config,
            cmvn_stats=cmvn_stats, train=False,
        )
        return metrics

    return jax.jit(eval_fn)
