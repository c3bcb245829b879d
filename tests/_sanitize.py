"""The fixture that arms a port suite with ``SENTIO_SANITIZE=1``.

A suite imports it by name (``from _sanitize import _sanitized``), which
makes it that module's own module-scoped autouse fixture."""

import os

import pytest


@pytest.fixture(scope="module", autouse=True)
def _sanitized():
    """SENTIO_SANITIZE=1 for the module, set before its engine fixtures
    build: each engine's entry points check the single-driver thread, the
    serving locks are owned, ordered and lockset-checked, and every tick
    checks page conservation, radix refcounts and the pool's layout."""
    prior = os.environ.get("SENTIO_SANITIZE")
    os.environ["SENTIO_SANITIZE"] = "1"
    yield
    if prior is None:
        os.environ.pop("SENTIO_SANITIZE", None)
    else:
        os.environ["SENTIO_SANITIZE"] = prior
