"""Test environment setup.

By default tests run on the CPU backend with float64 enabled
(numerical-parity mode) and 8 virtual devices, so multi-device sharding
paths are exercised without several accelerators — JAX's idiomatic fake
distributed backend. Must run before jax is used anywhere.

Setting JAX_PLATFORMS explicitly (e.g. `JAX_PLATFORMS=cuda python -m pytest
-m gpu tests/`) leaves the platform choice to it, so the tests marked
`gpu` can reach the card; they skip themselves elsewhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
