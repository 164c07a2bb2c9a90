"""Test harness configuration.

Runs JAX on the host CPU with 8 virtual devices unless JAX_PLATFORMS says
otherwise, so the whole suite — including the multi-device sharding tests —
runs anywhere; the tests marked ``gpu`` skip there. Must run before any
test module imports jax-dependent code.
"""
import os

# Must be set before the XLA CPU client is instantiated.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
