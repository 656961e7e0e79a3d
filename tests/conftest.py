# NOTE: deliberately NO XLA_FLAGS here — smoke tests and benches must see
# the real single CPU device; only launch/dryrun.py forces 512 devices.
import os
import tempfile
import warnings

warnings.filterwarnings("ignore")

# point the fitted-NetworkModel lookup at an empty dir: a profile written
# by a local `make calibrate-smoke` must not leak into `auto`-ranking
# tests (obs tests override this per-test).  Inherited by the
# subprocess-based multidevice/bench workers via os.environ.
os.environ["REPRO_NETPROFILE_DIR"] = tempfile.mkdtemp(
    prefix="repro-netprofiles-test-")

import jax
import pytest

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture(scope="session")
def smoke_mesh():
    from repro.launch.mesh import make_smoke_mesh

    return make_smoke_mesh(1, 1)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
