"""Compile-cache directory rule and removed config keys."""

import os

import pytest

from gluon_e2e_asr.config import Config, apply_overrides, load_config
from gluon_e2e_asr.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}, "/somewhere/else"),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_ENABLE_COMPILATION_CACHE": "false"}, None),
    ({"JAX_ENABLE_COMPILATION_CACHE": "0",
      "JAX_COMPILATION_CACHE_DIR": "/x"}, None),
])
def test_compilation_cache_dir_rule(monkeypatch, env, want):
    for k in ("JAX_COMPILATION_CACHE_DIR", "JAX_ENABLE_COMPILATION_CACHE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert platform.compilation_cache_dir() == want


def test_default_cache_dir_is_in_checkout_and_ignored():
    assert platform.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# Keys of the removed Pallas kernels: a config that still sets one fails
# instead of being silently ignored.
@pytest.mark.parametrize("dotted", [
    "model.lstm_impl", "model.lstm_time_chunk", "model.dec_impl",
    "frontend.impl",
])
def test_removed_config_keys_fail_loudly(dotted, tmp_path):
    section, key = dotted.split(".")
    path = tmp_path / "cfg.yaml"
    path.write_text(f"{section}:\n  {key}: scan\n")
    with pytest.raises(KeyError, match="unknown config key"):
        load_config(str(path))
    with pytest.raises(KeyError, match="unknown config key"):
        apply_overrides(Config(), [f"{dotted}=scan"])


def test_every_checked_in_config_loads():
    import glob

    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))
                   + glob.glob(os.path.join(REPO, "tests", "goldens",
                                            "*.yaml")))
    assert len(paths) >= 10
    for p in paths:
        load_config(p)
