"""Test configuration: run everything on a virtual 8-device CPU mesh so
distributed code paths are exercised without several accelerators (per
SURVEY §4: ``xla_force_host_platform_device_count``). The platform is
pinned to the CPU through ``jax.config`` so the tests never claim a GPU.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
