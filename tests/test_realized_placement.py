"""Realized-duration bucket placement [VERDICT.md round-4 item 4].

With speed perturbation on, the sampler re-places each utterance per
epoch by the duration its deterministic factor draw actually produces
(sampler.perturb_factor), instead of reserving worst-case 1/min(f)
headroom — the headroom was measured as a large share of the 23.2%
padded-frame waste at the 100 h rehearsal. These tests pin the
invariants that make that sound:

* the loader and sampler see the SAME factor draw,
* every batch row the loader emits fits its bucket's static shape,
* placement is a pure function of (seed, epoch) — resume-safe,
* the realized assignment actually moves utterances between buckets
  across epochs (i.e. the feature is live, not vacuously static).
"""

import numpy as np

from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.manifest import build_synthetic_manifest
from gluon_e2e_asr.data.sampler import (
    BucketSampler,
    make_bucket_specs,
    perturb_factor,
)
from gluon_e2e_asr.data.tokenizer import CharTokenizer

SP = (0.9, 1.0, 1.1)


def _fixture(n=48, bounds=(1.2, 1.6, 8.0)):
    # Bounds straddle the synthetic fixture's duration range (0.44-1.7 s)
    # so the perturb draw (x0.909-x1.111) actually moves utterances
    # across the 1.2 s and 1.6 s boundaries between epochs.
    utts = build_synthetic_manifest(n, seed=0)
    specs = make_bucket_specs(list(bounds), 16000, 8, 64, 160, False)
    sampler = BucketSampler(utts, specs, 16000, seed=3, shuffle=True,
                            speed_perturb=SP, perturb_seed=7)
    loader = DataLoader(utts, sampler, CharTokenizer(), 16000,
                        speed_perturb=SP, perturb_seed=7)
    return utts, specs, sampler, loader


def test_loader_and_sampler_share_the_draw():
    _, _, sampler, loader = _fixture()
    for epoch in (0, 1, 5):
        for i in (0, 7, 23):
            assert loader._perturb_factor(epoch, i) == perturb_factor(
                7, epoch, i, SP)


def test_every_realized_row_fits_its_bucket():
    utts, specs, sampler, loader = _fixture()
    for epoch in (0, 1, 2):
        for b in loader.epoch(epoch):
            # make_batch yields padded [bs, max_samples]; valid lengths
            # must never exceed the static bucket shape (the clamp may
            # shave <=2 samples of manifest-rounding slack, never more).
            bucket_cap = b.audio.shape[1]
            assert np.all(b.audio_len <= bucket_cap)
            for row in range(b.num_real):
                i = next(j for j, u in enumerate(utts)
                         if u.utt_id == b.utt_ids[row])
                f = perturb_factor(7, epoch, i, SP)
                want = int(round(round(utts[i].duration * 16000) / f))
                assert abs(int(b.audio_len[row]) - min(want, bucket_cap)) <= 2


def test_epoch_batches_deterministic():
    _, _, sampler, _ = _fixture()
    for epoch in (0, 1, 4):
        a = [(b, list(ix)) for b, ix in sampler.epoch_batches(epoch)]
        b_ = [(b, list(ix)) for b, ix in sampler.epoch_batches(epoch)]
        assert a == b_


def test_assignment_varies_across_epochs():
    _, specs, sampler, _ = _fixture()
    def bucket_of(epoch):
        m = {}
        for b, idxs in enumerate(sampler._epoch_assignments(epoch)):
            for i in idxs:
                m[i] = b
        return m
    m0, m1 = bucket_of(0), bucket_of(1)
    moved = [i for i in m0 if m1.get(i) != m0[i]]
    assert moved, "realized placement never moved an utterance between buckets"


def test_no_perturb_reduces_to_static():
    utts = build_synthetic_manifest(16, seed=0)
    specs = make_bucket_specs([2.0, 4.0, 8.0], 16000, 8, 64, 160, False)
    s = BucketSampler(utts, specs, 16000, seed=3, shuffle=False)
    assert s._epoch_assignments(0) is s.assignments


def test_static_placement_flag_restores_worst_case():
    """data.static_placement=True keeps the one-shot worst-case
    assignment even with speed_perturb on (the pre-round-5 behavior;
    the control arm of the BASELINE.md bucket-retune A/B)."""
    utts = build_synthetic_manifest(48, seed=0)
    specs = make_bucket_specs([1.2, 1.6, 8.0], 16000, 8, 64, 160, False)
    s = BucketSampler(utts, specs, 16000, seed=3, shuffle=True,
                      speed_perturb=SP, perturb_seed=7,
                      static_placement=True)
    assert s._epoch_assignments(0) is s.assignments
    assert s._epoch_assignments(5) is s.assignments
    # and the static assignment reserved the 1/min(f) headroom: every
    # utterance fits its bucket even at the slowest draw
    for b, idxs in enumerate(s.assignments):
        for i in idxs:
            n = int(round(round(utts[i].duration * 16000) / min(SP)))
            assert n <= specs[b].max_samples
