import os
import sys


def pytest_configure(config):
    # CI runs the fast tier first (-m "not slow"), then -m slow: a fast
    # failure short-circuits before any multi-device subprocess spawns.
    config.addinivalue_line(
        "markers",
        "slow: ICI-subprocess tests (forced multi-device meshes / driver "
        "e2e runs in child processes)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels have "
        "no CPU mode); skips on a host without one")

# Tests must see exactly ONE device (the dry-run forces 512 in its own
# subprocess only). Keep XLA flags clean here.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro  # noqa: E402,F401  (installs the JAX forward-compat shims)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

# The container has no `hypothesis` wheel; register the minimal local
# stand-in so the property tests still run (see _minihypothesis.py).
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _minihypothesis

    sys.modules["hypothesis"] = _minihypothesis
