"""Training orchestration: the host epoch loop around the jitted step.

Implements the §3.1 call stack of SURVEY.md: config -> vocab/manifests
-> bucketed sampler -> init -> per-epoch batch loop (one compiled XLA
program per bucket shape) -> dev eval (greedy WER) -> checkpoint best
[BASELINE.json:L5,L7,L10].
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import Config
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.manifest import (
    Utterance,
    build_librispeech_manifest,
    build_synthetic_manifest,
    load_manifest,
)
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import build_tokenizer
from gluon_e2e_asr.decoding.greedy import ids_to_texts, make_greedy_decoder
from gluon_e2e_asr.eval.metrics import cer, wer
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.parallel.mesh import make_mesh, shard_batch_arrays
from gluon_e2e_asr.training.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from gluon_e2e_asr.training.train_step import (
    accumulate_grads,
    create_train_state,
    make_apply_step,
    make_eval_loss_step,
    make_grad_step,
    make_optimizer,
    make_train_step,
)
from gluon_e2e_asr.utils.logging import JsonlLogger


def build_datasets(config: Config) -> Tuple[List[Utterance], List[Utterance]]:
    dc = config.data
    if dc.dataset == "synthetic":
        # (--set parses the literal "none" to None; both mean no split.)
        if dc.synth_split not in ("none", "sentence", None):
            raise ValueError(f"unknown data.synth_split {dc.synth_split!r}")
        disjoint = dc.synth_split == "sentence"
        train = build_synthetic_manifest(
            dc.synth_num_train, dc.synth_seed, dc.synth_min_tokens,
            dc.synth_max_tokens, prefix="train", text_mode=dc.synth_text,
            noise=dc.synth_noise, jitter=dc.synth_jitter,
            split="train" if disjoint else "all",
        )
        dev = build_synthetic_manifest(
            dc.synth_num_dev, dc.synth_seed + 1, dc.synth_min_tokens,
            dc.synth_max_tokens, prefix="dev", text_mode=dc.synth_text,
            noise=dc.synth_noise, jitter=dc.synth_jitter,
            split="dev" if disjoint else "all",
        )
        return train, dev
    if dc.dataset == "librispeech":
        if dc.train_manifest:
            return load_manifest(dc.train_manifest), load_manifest(dc.dev_manifest)
        train = build_librispeech_manifest(dc.data_dir, "train-clean-100")
        dev = build_librispeech_manifest(dc.data_dir, "dev-clean")
        return train, dev
    raise ValueError(f"unknown dataset {dc.dataset}")


class Trainer:
    def __init__(self, config: Config, workdir: str = "."):
        self.config = config
        self.workdir = workdir
        self.logger = JsonlLogger(
            os.path.join(workdir, config.train.metrics_path)
        )

        # Manifest-walk / synth-build time is an at-scale IO economics
        # number the 100 h rehearsal records [VERDICT.md round-3 item 2].
        t_walk = time.perf_counter()
        self.train_utts, self.dev_utts = build_datasets(config)
        self.logger.log({
            "event": "datasets",
            "manifest_walk_s": round(time.perf_counter() - t_walk, 2),
            "train_utts": len(self.train_utts),
            "dev_utts": len(self.dev_utts),
        })
        self.tokenizer = build_tokenizer(
            config, (u.text for u in self.train_utts))
        specs = make_bucket_specs(
            config.data.bucket_bounds_sec,
            config.data.sample_rate,
            config.data.batch_size,
            config.data.max_label_len,
            config.frontend.hop_length,
            config.data.dynamic_batch,
        )
        # Speed perturbation (train split only): the sampler places each
        # utterance per epoch by the duration its deterministic factor
        # draw will actually produce (realized placement — no worst-case
        # headroom padding; see BucketSampler docstring). The loader
        # shares the same draw via sampler.perturb_factor.
        sp = tuple(config.data.speed_perturb or ())
        if sp and min(sp) <= 0:
            raise ValueError(
                f"data.speed_perturb factors must be > 0: {sp}")
        self.sampler = BucketSampler(
            self.train_utts, specs, config.data.sample_rate,
            seed=config.train.seed, shuffle=config.data.shuffle,
            drop_last=config.data.drop_last,
            sortagrad_epochs=config.data.sortagrad_epochs,
            speed_perturb=sp, perturb_seed=config.train.seed,
            static_placement=config.data.static_placement,
        )
        self.loader = DataLoader(
            self.train_utts, self.sampler, self.tokenizer,
            config.data.sample_rate,
            speed_perturb=sp, perturb_seed=config.train.seed,
            transfer_dtype=config.data.transfer_dtype,
        )
        self.dev_sampler = BucketSampler(
            self.dev_utts, specs, config.data.sample_rate,
            seed=0, shuffle=False,
        )
        self.dev_loader = DataLoader(
            self.dev_utts, self.dev_sampler, self.tokenizer,
            config.data.sample_rate,
            transfer_dtype=config.data.transfer_dtype,
        )

        # Surface silently unbucketable utterances [code-review finding]:
        # dropped data must never be invisible.
        for name, s, utts in (("train", self.sampler, self.train_utts),
                              ("dev", self.dev_sampler, self.dev_utts)):
            if s.skipped:
                self.logger.log({
                    "event": "data_skipped",
                    "split": name,
                    "skipped": len(s.skipped),
                    "total": len(utts),
                    "hint": "utterances exceeding every bucket bound "
                            "(duration or label budget) are dropped",
                })

        self.model = build_model(
            config, self.tokenizer.vocab_size,
            self.tokenizer.sos_id, self.tokenizer.eos_id,
        )
        self.tx = make_optimizer(config)
        self.mesh = make_mesh() if config.train.dp else None
        self.n_chips = len(jax.devices()) if config.train.dp else 1
        if self.mesh is not None:
            # Grads must shard evenly: EVERY bucket's batch size (with
            # data.dynamic_batch they differ from data.batch_size) has to
            # divide the device count. Fail at init, not mid-epoch.
            ndev = self.mesh.devices.size
            bad = sorted({s.batch_size for s in self.sampler.specs
                          if s.batch_size % ndev})
            if bad:
                raise ValueError(
                    f"train.dp needs every bucket batch size divisible by "
                    f"the device count ({ndev}); got {bad} — adjust "
                    "data.batch_size / data.bucket_bounds_sec or disable "
                    "data.dynamic_batch")
        self.cmvn_stats = None
        if config.frontend.cmvn == "global":
            path = config.frontend.cmvn_stats_path
            if not path or not os.path.exists(path):
                raise FileNotFoundError(
                    "frontend.cmvn == 'global' requires cmvn_stats_path "
                    "(generate with tools/compute_cmvn.py), got: "
                    f"{path!r}"
                )
            blob = np.load(path)
            self.cmvn_stats = (
                jnp.asarray(blob["mean"]), jnp.asarray(blob["std"])
            )

        # Init params from the first bucket that has data.
        sample = self._sample_batch()
        self.state = create_train_state(
            config, self.model, self.tx, sample, self.cmvn_stats
        )
        self.train_step = make_train_step(
            self.model, config, self.tx, self.mesh, self.cmvn_stats
        )
        # Gradient accumulation (train.accum_grad_steps > 1): micro-batch
        # grad step + separate optimizer apply [SURVEY.md §2.1 #14].
        self.accum = max(1, int(config.train.accum_grad_steps))
        if self.accum > 1:
            self.grad_step = make_grad_step(
                self.model, config, self.mesh, self.cmvn_stats)
            self.apply_step = make_apply_step(self.tx)
        self._acc = None  # weighted-grad sum pytree
        self._acc_m = None  # weighted loss-metric sums
        self._acc_n = None  # total real rows in the open group
        self._micro = 0  # micro-batches in the open group
        # Dev eval decoder follows decode.method: greedy CTC needs a trained
        # CTC head (mtl_alpha > 0); pure-attention configs (milestone 3)
        # evaluate with the att-only beam. Under DP the eval shards the
        # batch over the same mesh as training (results are identical to
        # single-device decode — tests/test_parallel.py DP-decode test) so
        # a multi-chip pod doesn't idle N-1 chips during the epoch eval;
        # falls back to single-device when the batch doesn't divide.
        # Every bucket's batch size must shard evenly — with
        # data.dynamic_batch the per-bucket sizes differ from
        # data.batch_size.
        eval_mesh = self.mesh
        if eval_mesh is not None:
            bad = sorted({
                s.batch_size for s in self.dev_sampler.specs
                if s.batch_size % eval_mesh.devices.size
            })
            if bad:
                # Loud, like the train-time divisibility check: a
                # multi-chip user should know the epoch eval is about to
                # idle N-1 chips [VERDICT.md round-2 weak 4].
                self.logger.log({
                    "event": "dp_eval_fallback",
                    "reason": "dev bucket batch sizes not divisible by "
                              "device count",
                    "bad_batch_sizes": bad,
                    "devices": int(eval_mesh.devices.size),
                })
                eval_mesh = None
        if config.decode.method in ("beam", "ctc_beam"):
            from gluon_e2e_asr.decoding.beam import make_beam_decoder

            self._beam = make_beam_decoder(
                self.model, config, self.tokenizer, self.cmvn_stats,
                mesh=eval_mesh,
            )
            self.greedy = None
        else:
            self.greedy = make_greedy_decoder(self.model, config,
                                              self.cmvn_stats,
                                              mesh=eval_mesh)
            self._beam = None
        self.epoch0 = 0
        self.skip_batches = 0  # mid-epoch resume position
        self.best_wer = float("inf")
        # Early-stop staleness counter (epochs since the last best dev
        # WER). Not checkpointed: a resumed run restarts its patience
        # window, which only ever errs toward training longer.
        self._stale_epochs = 0
        if config.train.debug_nans:
            jax.config.update("jax_debug_nans", True)

    def _sample_batch(self) -> Dict[str, np.ndarray]:
        for bucket, idxs in self.sampler.epoch_batches(0):
            b = self.loader.make_batch(bucket, idxs)
            return {
                "audio": b.audio, "audio_len": b.audio_len,
                "labels": b.labels, "label_len": b.label_len,
            }
        raise RuntimeError("no training batches — check bucket bounds")

    # ------------------------------------------------------------------
    def maybe_resume(self) -> None:
        path = latest_checkpoint(os.path.join(self.workdir,
                                              self.config.train.ckpt_dir))
        if path is None:
            return
        self.state, cmvn, meta = restore_checkpoint(path, self.state)
        if cmvn is not None:
            self.cmvn_stats = cmvn
        # Vocab identity is load-bearing (model head width, label ids):
        # a resumed run must rebuild the exact tokenizer the checkpoint
        # trained with. Char and BPE construction are both deterministic
        # given the same config + manifest, so mismatch means the data
        # or config changed under the run — fail loudly.
        if meta.get("vocab_hash") and (
                meta["vocab_hash"] != self.tokenizer.fingerprint()):
            raise ValueError(
                f"resume vocab mismatch: checkpoint {path} was trained "
                f"with vocab {meta['vocab_hash']}, this run built "
                f"{self.tokenizer.fingerprint()} (did data.tokenizer / "
                f"the train manifest change?)")
        # Exact resume [SURVEY.md §5 failure detection]: a mid-epoch
        # checkpoint records how many batches of its epoch were consumed;
        # the deterministic (seed, epoch)-keyed sampler then replays the
        # remainder, reproducing the uninterrupted run bit-for-bit.
        batches_done = int(meta.get("batches_done", -1))
        epoch = int(meta.get("epoch", -1))
        if batches_done >= 0:
            self.epoch0 = epoch
            self.skip_batches = batches_done
        else:
            self.epoch0 = epoch + 1
            self.skip_batches = 0
        self.best_wer = float(meta.get("best_wer", float("inf")))
        self.logger.log({
            "event": "resume", "ckpt": path, "epoch": self.epoch0,
            "skip_batches": self.skip_batches,
        })

    def _device_batch(self, b) -> Dict[str, jnp.ndarray]:
        arrays = {
            "audio": b.audio, "audio_len": b.audio_len,
            "labels": b.labels, "label_len": b.label_len,
        }
        if self.mesh is not None:
            return shard_batch_arrays(self.mesh, arrays)
        return arrays

    def _accum_micro(self, batch):
        """One accumulation micro-batch. Returns (metrics, stepped):
        metrics is None until the group's optimizer apply fires."""
        self.state, grads, m = self.grad_step(self.state, batch)
        n = m["num_real"].astype(jnp.float32)
        sums = {k: m[k] * n
                for k in ("loss", "loss_ctc", "loss_att", "att_acc")}
        if self._acc is None:
            self._acc, self._acc_m, self._acc_n = grads, sums, n
        else:
            self._acc = accumulate_grads(self._acc, grads)
            self._acc_m = {k: self._acc_m[k] + sums[k] for k in sums}
            self._acc_n = self._acc_n + n
        self._micro += 1
        if self._micro < self.accum:
            return None, False
        return self._flush_accum(), True

    def _flush_accum(self):
        """Apply the open accumulation group; returns combined metrics."""
        self.state, grad_norm = self.apply_step(
            self.state, self._acc, self._acc_n)
        n = jnp.maximum(self._acc_n, 1.0)
        metrics = {k: v / n for k, v in self._acc_m.items()}
        metrics["grad_norm"] = grad_norm
        metrics["num_real"] = self._acc_n
        self._acc, self._acc_m, self._acc_n, self._micro = None, None, None, 0
        return metrics

    def train(self) -> Dict[str, float]:
        cfg = self.config
        tc = cfg.train
        step = int(self.state.step)
        profiling = False
        final = {}
        for epoch in range(self.epoch0, tc.num_epochs):
            t_epoch = time.perf_counter()
            utts_done, tokens_done = 0, 0
            real_samples, padded_samples = 0, 0
            window_t0, window_utts, window_tokens = time.perf_counter(), 0, 0
            skip = self.skip_batches if epoch == self.epoch0 else 0
            stopped_at = -1
            # Batches assemble in a background thread while the device
            # steps; resume fast-forward happens inside prefetch_epoch
            # (skipped batches are never built).
            prefetch = self.loader.prefetch_epoch(
                epoch, skip=skip, depth=cfg.data.prefetch_depth)
            try:
                for batch_idx, b in prefetch:
                    if 0 < tc.max_steps <= step:
                        stopped_at = batch_idx
                        break
                    if tc.profile_dir and step == tc.profile_start_step:
                        jax.profiler.start_trace(tc.profile_dir)
                        profiling = True
                    batch = self._device_batch(b)
                    if self.accum == 1:
                        self.state, metrics = self.train_step(
                            self.state, batch)
                        stepped = True
                    else:
                        metrics, stepped = self._accum_micro(batch)
                    if stepped:
                        step += 1
                    if profiling and step >= tc.profile_start_step + tc.profile_num_steps:
                        jax.block_until_ready(self.state.params)
                        jax.profiler.stop_trace()
                        profiling = False
                    utts_done += b.num_real
                    # Bucket-padding economics: device samples spent on
                    # pad (bucket static shape + pad rows) vs real audio
                    # [VERDICT.md round-3 item 2 "bucket padding waste"].
                    real_samples += int(b.audio_len.sum())
                    padded_samples += int(b.audio.shape[0] * b.audio.shape[1])
                    window_utts += b.num_real
                    window_tokens += int(b.label_len.sum())
                    tokens_done += int(b.label_len.sum())
                    if stepped and step % tc.log_every_steps == 0:
                        metrics = jax.device_get(metrics)
                        dt = time.perf_counter() - window_t0
                        rec = {
                            "event": "train",
                            "step": step,
                            "epoch": epoch,
                            "bucket": b.bucket,
                            "loss": round(float(metrics["loss"]), 5),
                            "loss_ctc": round(float(metrics["loss_ctc"]), 5),
                            "loss_att": round(float(metrics["loss_att"]), 5),
                            "att_acc": round(float(metrics["att_acc"]), 4),
                            "grad_norm": round(float(metrics["grad_norm"]), 4),
                            "utt_per_sec_per_chip": round(
                                window_utts / max(dt, 1e-9) / self.n_chips, 2
                            ),
                            "tokens_per_sec": round(
                                window_tokens / max(dt, 1e-9), 1
                            ),
                        }
                        self.logger.log(rec)
                        window_t0, window_utts, window_tokens = (
                            time.perf_counter(), 0, 0)
                    # `stepped` keeps mid-epoch checkpoints on accumulation
                    # boundaries (no partial grad group to lose on resume).
                    if (stepped and tc.ckpt_every_steps
                            and step % tc.ckpt_every_steps == 0):
                        self._checkpoint(epoch, None, batches_done=batch_idx + 1)
            finally:
                prefetch.close()
            train_time = time.perf_counter() - t_epoch
            if self._micro > 0 and stopped_at < 0:
                # Epoch length not divisible by accum_grad_steps: apply
                # the remainder group (its samples still count once, with
                # the group's own exact mean). max_steps breaks always
                # land on group boundaries (step only moves at applies),
                # so no group is ever abandoned.
                self._flush_accum()
                step += 1
            if stopped_at >= 0:
                # max_steps hit mid-epoch: checkpoint with the resume
                # position instead of marking the epoch complete.
                self._checkpoint(epoch, None, batches_done=stopped_at)
                break
            # --- end of epoch: dev eval + checkpoint [SURVEY.md §3.1] ---
            dev = self.evaluate()
            epoch_time = time.perf_counter() - t_epoch
            rec = {
                "event": "epoch",
                "epoch": epoch,
                "step": step,
                "epoch_time_s": round(epoch_time, 2),
                # Host/device overlap: fraction of the TRAIN portion the
                # consumer was NOT blocked waiting on batch assembly.
                "prefetch_occupancy": round(
                    1.0 - prefetch.consumer_wait_s
                    / max(train_time, 1e-9), 4),
                "utt_per_sec_per_chip": round(
                    utts_done / max(epoch_time, 1e-9) / self.n_chips, 2
                ),
                "tokens_per_sec": round(
                    tokens_done / max(epoch_time, 1e-9), 1),
                "pad_waste": round(
                    1.0 - real_samples / max(padded_samples, 1), 4),
                **{k: round(v, 4) for k, v in dev.items()},
            }
            self.logger.log(rec)
            is_best = dev["dev_wer"] < self.best_wer
            if is_best:
                self.best_wer = dev["dev_wer"]
                self._stale_epochs = 0
            else:
                self._stale_epochs += 1
                self._plateau_anneal(epoch)
            self._checkpoint(epoch, is_best, dev_wer=dev["dev_wer"])
            final = rec
            if 0 < tc.max_steps <= step:
                break
            if (tc.early_stop_patience > 0
                    and self._stale_epochs >= tc.early_stop_patience):
                self.logger.log({
                    "event": "early_stop",
                    "epoch": epoch,
                    "best_wer": self.best_wer,
                    "patience": tc.early_stop_patience,
                })
                break
        return final

    def _plateau_anneal(self, epoch: int) -> None:
        """Criterion-based annealing on a no-new-best epoch (the reference
        family's adadelta recipe): multiply the optimizer's injected eps
        by train.eps_decay, optionally reloading model params from the
        best checkpoint first (train.plateau_restore_best). No-op unless
        train.eps_decay > 0. The decayed eps lives in opt_state, so the
        epoch's checkpoint (written right after) carries it into resume."""
        tc = self.config.train
        if tc.eps_decay <= 0 and not tc.plateau_restore_best:
            return
        # Patience gating: act only at the end of each full window of
        # consecutive no-best epochs (window length eps_decay_patience).
        patience = max(1, int(tc.eps_decay_patience))
        if self._stale_epochs % patience != 0:
            return
        # Restore first (independent of the optimizer family), then anneal.
        restored = False
        if tc.plateau_restore_best:
            best = os.path.join(self.workdir, tc.ckpt_dir, "best.msgpack")
            if os.path.exists(best):
                best_state, _, _ = restore_checkpoint(best, self.state, params_only=True)
                self.state = self.state.replace(params=best_state.params)
                restored = True
        if tc.eps_decay <= 0:
            if restored:
                self.logger.log({
                    "event": "plateau_restore",
                    "epoch": epoch,
                })
            return
        from gluon_e2e_asr.training.train_step import decay_opt_eps

        new_opt, old_eps, new_eps = decay_opt_eps(
            self.state.opt_state, tc.eps_decay)
        if old_eps is None:
            self.logger.log({
                "event": "eps_decay_skipped",
                "epoch": epoch,
                "restored_best": restored,
                "hint": "train.eps_decay set but the optimizer has no "
                        "injected eps (use train.optimizer: adadelta)",
            })
            return
        self.state = self.state.replace(opt_state=new_opt)
        self.logger.log({
            "event": "eps_decay",
            "epoch": epoch,
            "eps_old": old_eps,
            "eps_new": new_eps,
            "restored_best": restored,
        })

    def _checkpoint(self, epoch: int, is_best: Optional[bool],
                    batches_done: int = -1,
                    dev_wer: Optional[float] = None) -> None:
        meta = {
            "epoch": epoch,
            "batches_done": batches_done,
            "config_hash": self.config.fingerprint(),
            "vocab": self.tokenizer.to_json(),
            "vocab_hash": self.tokenizer.fingerprint(),
            "best_wer": self.best_wer,
        }
        if dev_wer is not None:
            # This epoch's dev WER: what keep_policy="best" ranks by.
            meta["dev_wer"] = float(dev_wer)
        t_save = time.perf_counter()
        save_checkpoint(
            os.path.join(self.workdir, self.config.train.ckpt_dir),
            self.state,
            meta,
            self.cmvn_stats,
            keep=self.config.train.keep_ckpts,
            is_best=bool(is_best),
            keep_policy=self.config.train.keep_policy,
        )
        # Checkpoint-IO economics at corpus scale (msgpack serialize +
        # fsync + prune) [VERDICT.md round-3 item 2].
        self.logger.log({
            "event": "ckpt_io",
            "epoch": epoch,
            "save_s": round(time.perf_counter() - t_save, 3),
            "best": bool(is_best),
        })

    def evaluate(self) -> Dict[str, float]:
        """Greedy-decode the dev set and score WER/CER [BASELINE.json:L2]."""
        refs, hyps = [], []
        by_id = {u.utt_id: u for u in self.dev_utts}
        for b in self.dev_loader.epoch(0):
            if self.greedy is not None:
                ids, lens = self.greedy(
                    self.state.params, jnp.asarray(b.audio),
                    jnp.asarray(b.audio_len)
                )
                texts = ids_to_texts(np.asarray(ids), np.asarray(lens),
                                     self.tokenizer)
            else:
                texts, _ = self._beam(
                    self.state.params, jnp.asarray(b.audio),
                    jnp.asarray(b.audio_len)
                )
            for row, utt_id in enumerate(b.utt_ids):
                refs.append(by_id[utt_id].text)
                hyps.append(texts[row])
        return {
            "dev_wer": wer(refs, hyps),
            "dev_cer": cer(refs, hyps),
        }
