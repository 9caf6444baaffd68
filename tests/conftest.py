"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so distributed (`jax.sharding`)
paths are exercised without accelerator hardware.  The one exception is
``python -m pytest -m gpu``: tests marked ``gpu`` run on the card, so for
that selection the platform is left to JAX (each such test skips, through
the ``gpu_device`` fixture, where no GPU is found).
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    if config.getoption("markexpr", "") != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU device; skips the test where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


@pytest.fixture(scope="session")
def sphere_mesh():
    """Small test sphere (2562 vertices) with operators."""
    from gravo_mg.utils.laplacian import cotan_laplacian, mass_voronoi
    from gravo_mg.utils.meshgen import icosphere
    from gravo_mg.utils.neighbors import neighbors_from_faces

    V, F = icosphere(4, bump=0.1)
    S = cotan_laplacian(V, F)
    M = mass_voronoi(V, F)
    neigh = neighbors_from_faces(F)
    return {"V": V, "F": F, "S": S, "M": M, "neigh": neigh}


@pytest.fixture(scope="session")
def medium_mesh():
    """Medium sphere (10242 vertices) for end-to-end solver tests."""
    from gravo_mg.utils.laplacian import cotan_laplacian, mass_voronoi
    from gravo_mg.utils.meshgen import icosphere
    from gravo_mg.utils.neighbors import neighbors_from_faces

    V, F = icosphere(5, bump=0.1)
    S = cotan_laplacian(V, F)
    M = mass_voronoi(V, F)
    neigh = neighbors_from_faces(F)
    return {"V": V, "F": F, "S": S, "M": M, "neigh": neigh}
