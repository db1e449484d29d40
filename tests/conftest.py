"""Test environment: force CPU with 8 virtual devices so mesh/DP tests run
without accelerators [SURVEY.md §4 "Distributed: DP"], and keep the
persistent compilation cache off so test runs write nothing into the
checkout. Must run before jax is imported anywhere."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

assert jax.default_backend() == "cpu", jax.default_backend()
