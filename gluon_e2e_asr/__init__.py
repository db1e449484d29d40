"""End-to-end hybrid CTC/attention ASR in JAX.

A JAX rebuild of the capabilities of the MXNet-Gluon reference stack ``Hex-Lee/gluon-e2e-asr`` (the reference
checkout was empty at survey time — see SURVEY.md §0 — so the contract
is BASELINE.json, cited throughout as [BASELINE.json:L<n>]).

Capability surface [BASELINE.json:L5]:
  - acoustic frontend (framing, STFT, log-Mel, CMVN, SpecAugment)
    composed in jax.numpy and jitted with the step
  - XLA-scanned BiLSTM encoder + LAS attention decoder over
    length-bucketed padded batches
  - on-device CTC forward-backward (alpha-beta) and joint
    CTC-attention losses
  - data-parallel training over the local devices with gradient
    allreduce
  - batched beam-search decoding with CTC prefix scoring + length
    normalization
"""

__version__ = "0.1.0"
