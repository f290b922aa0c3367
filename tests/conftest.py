"""Test configuration: CPU platform with 8 virtual devices, float64 enabled.

Must run before any jax import: tests validate numerics in f64 on CPU and
multi-device sharding on a virtual 8-device mesh (the driver separately
dry-runs the multi-chip path).
"""

import os

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from metalquicha_tpu.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()

import pytest  # noqa: E402, F401
