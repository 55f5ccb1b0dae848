import os
import sys

import pytest

# Single-process smoke tests run on the CPU backend; subprocess-based
# distributed tests (tests/test_distributed.py) set their own XLA_FLAGS.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Multi-device CI harness (DESIGN.md §13): the tensor-parallel serving
# tests need >= 8 host-platform devices, and the flag only takes effect
# BEFORE jax initializes. Appended (never overwriting an explicit count)
# and only while jax is still unimported — if some plugin imported jax
# first, the ``multidevice`` marker below turns into a skip instead of a
# suite-wide mystery failure.
_DEVICE_FLAG = "--xla_force_host_platform_device_count"
if "jax" not in sys.modules and _DEVICE_FLAG not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" {_DEVICE_FLAG}=8").strip()

# hypothesis is optional (offline containers may lack it): register the CI
# profile only when importable. Property tests themselves are guarded by
# tests/_hypothesis_compat.py, which skips them when the package is absent.
try:
    from hypothesis import HealthCheck, settings
except ImportError:
    pass
else:
    settings.register_profile(
        "ci", max_examples=20, deadline=None,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: needs >= 8 local devices "
        "(XLA_FLAGS=--xla_force_host_platform_device_count=8 before jax "
        "initializes)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (an NVIDIA H100 for the sm_90a kernels); "
        "skipped without one — run with `pytest -m gpu tests/test_torch_gpu.py`")


def pytest_collection_modifyitems(config, items):
    marked = [it for it in items if "multidevice" in it.keywords]
    if not marked:
        return
    import jax
    n = jax.device_count()
    if n >= 8:
        return
    skip = pytest.mark.skip(
        reason=f"needs 8 devices, have {n}: the host-platform device flag "
               f"did not take effect (jax initialized before conftest?)")
    for it in marked:
        it.add_marker(skip)
