"""Test config: run on the CPU with 8 virtual devices unless the caller
picked a platform.

With JAX_PLATFORMS unset the tests run on the CPU; on the CPU platform
XLA is given 8 virtual devices for the mesh and sharding tests.  Set
JAX_PLATFORMS=cuda to run the `gpu`-marked tests on a card (see README).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
