"""Test configuration: tests run on the CPU with 8 virtual devices, so the
sharding and collective paths run without an accelerator.  With
DUET_TPU_TEST_REAL=1 they run on the machine's own backend instead, which
the `chip` tests need (`DUET_TPU_TEST_REAL=1 python -m pytest -m chip`)."""

import os

if not os.environ.get("DUET_TPU_TEST_REAL"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import pytest


@pytest.fixture(scope="session")
def sim_dataset(tmp_path_factory):
    """One shared small simulated dataset for the session."""
    from duet_tpu.sim import SimConfig, simulate_dataset

    out = tmp_path_factory.mktemp("simdata")
    cfg = SimConfig(contigs={"chr21": 200_000}, seed=7, coverage=18.0,
                    read_len_mean=9_000)
    truth = simulate_dataset(str(out), cfg)
    return str(out), cfg, truth


@pytest.fixture
def gpu():
    """The GPU device for a `chip` test; skips where JAX has none.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's first device is {dev.platform}); "
                    "run with DUET_TPU_TEST_REAL=1 on a GPU host")
    return dev
