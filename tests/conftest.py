"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding logic is validated on CPU (SURVEY.md §4).  The platform is
forced before JAX initializes a backend, so the suite never reaches for
an accelerator even on a machine that has one.  Tests of code that only
runs on the card carry the ``gpu`` marker and skip on the CPU (the
``gpu`` fixture below); chip_smoke.py runs them in its own process on
the card, with SVDFEATURE_TESTS_ON_CARD=1 so that this file leaves the
platform alone.  The persistent compile cache stays off: the suite
writes nothing outside its temporary directories.
"""

import os

ON_CARD = bool(os.environ.get("SVDFEATURE_TESTS_ON_CARD"))
if not ON_CARD:  # before the first jax import
    os.environ["JAX_NUM_CPU_DEVICES"] = "8"
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_compilation_cache", False)
    assert all(d.platform == "cpu" for d in jax.devices())

import gzip
import pathlib

import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
GOLDEN = pathlib.Path(__file__).parent.parent / "golden"
DEMO = pathlib.Path(__file__).parent.parent / "demo"


def cpu_devices(n=None):
    ds = jax.devices("cpu")
    return ds if n is None else ds[:n]


@pytest.fixture(scope="session")
def fixtures():
    return FIXTURES


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


def read_fixture_text(name: str) -> str:
    with gzip.open(FIXTURES / name, "rt") as f:
        return f.read()


@pytest.fixture(scope="session")
def ml100k_base_text():
    return read_fixture_text("ml100k.base.feature.gz")


@pytest.fixture(scope="session")
def ml100k_test_text():
    return read_fixture_text("ml100k.test.feature.gz")


@pytest.fixture
def gpu():
    """Card-only tests: decided here, at run time, never at import (the
    xdist workers must all collect the same tests)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; this process runs on {devs[0].platform}")
    return devs
