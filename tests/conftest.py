import os
import sys

# Tests run on the single default CPU device; distributed-semantics tests
# spawn subprocesses with their own XLA_FLAGS (test_distributed.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "real_hardware: needs real multi-accelerator hardware; CPU CI "
        "exercises the same paths via forced host-device fan-out "
        "(tests/test_distributed.py, tests/test_tp_serving.py) and "
        "these tests self-skip there")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
