"""Test env: force CPU backend with 8 virtual devices BEFORE jax initializes
(SURVEY.md §4.2 'sharding tests without a cluster').

Unit/model/sharding tests all run on the CPU backend. Tests marked `gpu`
skip here; `python chip_smoke.py` runs them on the card, along with the
end-to-end path.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # tests never touch the real chip
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere, runs as a "
        "phase of chip_smoke.py")


@pytest.fixture(scope="session")
def tiny_dataset():
    """Small synthetic dataset shared across tests (fixed seed)."""
    from score_tpu.data import synth
    from score_tpu.data.prep_common import build_dataset

    user, item, ts = synth.synth_events(300, 600, 20000, num_slots=8, seed=0)
    return build_dataset(user, item, ts, num_slots=8, user_fanout=6,
                         item_fanout=6, num_eval_neg=20, min_user=3,
                         min_item=3, seed=0, dataset_name="tiny")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
