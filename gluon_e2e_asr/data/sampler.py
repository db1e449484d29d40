"""Length-bucketed batch sampler with static bucket shapes.

Reference-side realization: Gluon ``FixedBucketSampler``-style grouping
[SURVEY.md §2.1 #3, INFERRED-high]. New-repo realization: utterances are
assigned to duration buckets with *static* padded shapes so every batch
from a bucket hits one cached XLA compilation — the bucket-shape
economics trade padding waste against compile count
[BASELINE.json:L5 "bucketed padding", L10 "bucketed batching";
SURVEY.md §7 hard part 4].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np

from gluon_e2e_asr.data.manifest import Utterance


@dataclass(frozen=True)
class BucketSpec:
    """Static shape contract for one bucket."""

    max_samples: int  # padded audio length (samples)
    max_labels: int  # padded label length (tokens)
    batch_size: int

    @property
    def shape_key(self) -> tuple:
        return (self.batch_size, self.max_samples, self.max_labels)


def make_bucket_specs(
    bounds_sec: Sequence[float],
    sample_rate: int,
    batch_size: int,
    max_label_len: int,
    hop_length: int = 160,
    dynamic_batch: bool = False,
) -> List[BucketSpec]:
    """One BucketSpec per duration bound. Audio lengths are rounded up to a
    whole number of frontend hops so downstream frame counts are exact.
    With ``dynamic_batch``, per-bucket batch size scales inversely with the
    bound so each batch carries roughly constant audio samples."""
    specs = []
    largest = bounds_sec[-1]
    for b in bounds_sec:
        n = int(round(b * sample_rate))
        n = ((n + hop_length - 1) // hop_length) * hop_length
        bs = batch_size
        if dynamic_batch:
            bs = max(1, int(batch_size * largest / b))
        # Label budget scales with duration. Real speech runs up to
        # ~17 chars/sec (LibriSpeech); budget 20/sec so no utterance is
        # dropped for text length unless it exceeds max_label_len.
        ml = min(max_label_len, max(8, int(np.ceil(b * 20))))
        specs.append(BucketSpec(max_samples=n, max_labels=ml, batch_size=bs))
    return specs


def perturb_factor(perturb_seed: int, epoch: int, utt_idx: int,
                   factors: Sequence[float]) -> float:
    """Deterministic per-(epoch, utterance) speed-perturb factor draw.

    Shared by DataLoader (which resamples the audio by it) and
    BucketSampler (which, in realized-placement mode, buckets each
    utterance by the duration this factor actually produces) — both see
    the SAME draw, which is what makes exact placement sound.
    """
    key = ((perturb_seed * 1000003 + epoch) * 1000003
           + utt_idx) & 0x7FFFFFFF
    r = np.random.RandomState(key)
    return factors[r.randint(len(factors))]


class BucketSampler:
    """Assign utterances to buckets; yield per-epoch batches of indices.

    Determinism: the epoch shuffle is keyed by (seed, epoch) so resume
    reproduces the uninterrupted batch order [SURVEY.md §5 checkpoint].

    Two placement modes:

    * static (default): each utterance is assigned once, by
      ``duration * duration_scale`` — worst-case headroom when speed
      perturbation is on (duration_scale = 1/min(factor)), so a
      stretched waveform always fits. Simple, but the headroom is pure
      padding whenever the epoch's draw is not the slowest factor
      (measured 23.2% padded-frame waste at the 100 h rehearsal).
    * realized (``speed_perturb`` given): placement is recomputed per
      epoch from the duration each utterance will ACTUALLY have after
      that epoch's deterministic factor draw (perturb_factor above) —
      no headroom at all. Pure function of (seed, perturb_seed, epoch),
      so mid-epoch resume still replays identical batches. The loader's
      max_samples clamp absorbs the <=2-sample rounding slack between
      the manifest's 0.1 ms-rounded duration and the decoded length.
    """

    def __init__(
        self,
        utts: Sequence[Utterance],
        specs: Sequence[BucketSpec],
        sample_rate: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = False,
        sortagrad_epochs: int = 0,
        duration_scale: float = 1.0,
        speed_perturb: Sequence[float] = (),
        perturb_seed: int = 0,
        static_placement: bool = False,
    ):
        self.specs = list(specs)
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        # SortaGrad (the reference family's curriculum knob): the first N
        # epochs run shortest-utterance-first with no shuffle (stabilizes
        # early CTC training); epoch N onward uses the normal
        # (seed, epoch)-keyed shuffle. Still a pure function of the epoch
        # number, so mid-epoch resume replays identically.
        self.sortagrad_epochs = int(sortagrad_epochs)
        self._durations = [float(u.duration) for u in utts]
        self._texts_len = [len(u.text) for u in utts]
        self._sample_rate = sample_rate
        self.speed_perturb = tuple(float(f) for f in speed_perturb)
        self.perturb_seed = perturb_seed
        # data.static_placement: keep the worst-case one-shot assignment
        # even with speed_perturb on (the pre-round-5 behavior; the
        # control arm of the bucket-retune A/B).
        self.static_placement = bool(static_placement)
        self.assignments: List[List[int]] = [[] for _ in self.specs]
        self.skipped: List[int] = []
        # Static placement (also the worst-case feasibility record in
        # realized mode): duration_scale > 1 reserves bucket room for
        # on-the-fly speed perturbation (data.speed_perturb): the
        # slowest factor f < 1 stretches audio by 1/f, and static
        # placement must guarantee the stretched waveform still fits its
        # bucket's shape. Realized mode re-places per epoch instead.
        if self.speed_perturb:
            duration_scale = 1.0 / min(self.speed_perturb)
        for i, u in enumerate(utts):
            n_samples = int(round(u.duration * duration_scale * sample_rate))
            placed = False
            for b, spec in enumerate(self.specs):
                if n_samples <= spec.max_samples and len(u.text) <= spec.max_labels:
                    self.assignments[b].append(i)
                    placed = True
                    break
            if not placed:
                self.skipped.append(i)

    def _epoch_assignments(self, epoch: int) -> List[List[int]]:
        """Bucket assignment for one epoch: realized durations when
        speed_perturb is set, the static worst-case otherwise."""
        if not self.speed_perturb or self.static_placement:
            return self.assignments
        assignments: List[List[int]] = [[] for _ in self.specs]
        sr = self._sample_rate
        for i, d in enumerate(self._durations):
            f = perturb_factor(self.perturb_seed, epoch, i,
                               self.speed_perturb)
            n_samples = int(round(round(d * sr) / f))
            for b, spec in enumerate(self.specs):
                if (n_samples <= spec.max_samples
                        and self._texts_len[i] <= spec.max_labels):
                    assignments[b].append(i)
                    break
        return assignments

    def num_batches(self) -> int:
        total = 0
        for b, idxs in enumerate(self.assignments):
            bs = self.specs[b].batch_size
            if self.drop_last:
                total += len(idxs) // bs
            else:
                total += (len(idxs) + bs - 1) // bs
        return total

    def epoch_batches(self, epoch: int) -> Iterator[tuple]:
        """Yield (bucket_index, [utt indices]) batches for one epoch."""
        sorta = epoch < self.sortagrad_epochs
        shuffle = self.shuffle and not sorta
        rng = np.random.RandomState((self.seed * 1000003 + epoch) & 0x7FFFFFFF)
        all_batches = []
        for b, idxs in enumerate(self._epoch_assignments(epoch)):
            order = np.array(idxs, dtype=np.int64)
            if sorta:
                # shortest first within the bucket (stable: ties keep
                # manifest order); buckets are already duration-ordered.
                order = order[np.argsort(
                    [self._durations[i] for i in idxs], kind="stable")]
            elif shuffle:
                rng.shuffle(order)
            bs = self.specs[b].batch_size
            for s in range(0, len(order), bs):
                chunk = order[s : s + bs]
                if len(chunk) < bs and self.drop_last:
                    continue
                all_batches.append((b, chunk.tolist()))
        if shuffle:
            rng.shuffle(all_batches)
        yield from all_batches
