"""Test configuration: force an 8-device virtual CPU platform.

Unit tests are platform-parity tests: multi-device sharding runs against
CPU device emulation (SURVEY.md §4 item 4), and kernels run in the Pallas
interpreter. The GPU is exercised by chip_smoke.py and bench.py instead.
This must run before jax is imported anywhere.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
