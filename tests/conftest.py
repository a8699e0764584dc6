"""Test configuration: CPU backend, 8 virtual devices for sharding tests, x64.

The config update below pins the tests to the (virtual) CPU even on a
machine with a GPU; tests marked `gpu` decide in their own body whether
a GPU backend is present.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
