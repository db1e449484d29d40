"""chip_smoke.py's phases at tiny widths on the CPU.

The script itself refuses any platform but the GPU; its phase functions
take the widths as arguments, so the same code paths run here small."""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY_MODEL = [
    "model.enc_hidden=16", "model.enc_layers=2", "model.enc_subsample=[1,2]",
    "model.dec_hidden=16", "model.dec_embed=8", "model.att_dim=8",
    "model.loc_conv_channels=2", "model.loc_conv_width=5",
    "data.synth_num_train=16", "data.synth_num_dev=8", "data.batch_size=8",
    "data.bucket_bounds_sec=[2.0]", "train.num_epochs=1",
    "train.log_every_steps=1", "decode.beam_size=2",
]


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert "needs platform 'gpu'" in str(e.value.code)
    out = capsys.readouterr().out
    assert '"ok"' not in out
    with pytest.raises(SystemExit):
        chip_smoke.main(["--four-cards"])


def test_phase_device_reports_jax_view(capsys):
    info = chip_smoke.phase_device("cpu")
    assert info["device"] == {"platform": "cpu", "kind": "cpu", "count": 8}
    assert "(a) nvidia-smi:" in capsys.readouterr().out


def test_phase_train_then_decode_and_transcribe(tmp_path):
    wd = str(tmp_path)
    tr = chip_smoke.phase_train(wd, chip_smoke.FLAGSHIP, TINY_MODEL, 2,
                                "cpu")
    assert len(tr["losses"]) == 2 and np.all(np.isfinite(tr["losses"]))
    assert tr["step_s"] > 0 and os.path.exists(tr["ckpt"])
    out = chip_smoke.phase_decode(wd, chip_smoke.FLAGSHIP, TINY_MODEL,
                                  tr["ckpt"], 3, "cpu")
    assert out["decode"]["num_utts"] == 3
    assert len(out["transcribe"]) == 2


def test_phase_step_memory_tiny():
    out = chip_smoke.phase_step_memory("cpu", batch=2, seconds=0.5,
                                       max_labels=6, tiny=True, steps=1)
    assert np.isfinite(out["loss"]) and out["step_s"] > 0


def test_phase_plain_paths_tiny():
    out = chip_smoke.phase_plain_paths("cpu", B=2, T_enc=12, H=8, D=8, L=4,
                                       T_dec=10, V=32, seconds=0.2,
                                       repeats=1)
    assert set(out) == {"bilstm_layer", "decoder_loc", "decoder_dot", "ctc",
                        "frontend"}
    assert all(v > 0 for v in out.values())


def test_phase_golden_matches_blessed_records(tmp_path):
    out = chip_smoke.phase_golden(str(tmp_path))
    for method in ("greedy", "beam"):
        assert out[method]["rc"] == 0
        assert out[method]["max_score_diff"] <= chip_smoke.GOLDEN_SCORE_TOL


def test_dp_phase_on_four_virtual_devices(capsys):
    from __graft_entry__ import dryrun_multichip

    rep = dryrun_multichip(4)
    assert rep["devices"] == 4 and rep["rows"] == 8
    assert rep["decode_hyps_identical"] == 8
    assert abs(rep["loss_det_pjit"] - rep["loss_det_shard_map"]) <= (
        rep["loss_det_tol"] * max(abs(rep["loss_det_shard_map"]), 1.0))
    assert "decode.dp ok" in capsys.readouterr().out


def test_dp_phase_needs_real_devices():
    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="needs 16 devices"):
        dryrun_multichip(16)


def test_last_line_contract(monkeypatch, capsys):
    """With the phases stubbed out, main() ends on the one JSON line the
    contract names, with the device as JAX reports it."""
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda p: {"device": dev, "card": "X, 700.00 W"})
    monkeypatch.setattr(chip_smoke, "run_one_card", lambda wd, card: {})
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "card: X, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": dev}
