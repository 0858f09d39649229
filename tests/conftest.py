"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding tests run without accelerators, the analogue of
testing an MPI code on a laptop (SURVEY.md §4). The platform is forced
to the CPU both in the environment and in JAX's config, so an
installed GPU plugin is never picked up by the tests.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices():
    return jax.devices()
