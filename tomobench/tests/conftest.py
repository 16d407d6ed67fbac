"""Fixtures of the benchmark's CPU tests: a throwaway checkout with tiny
cells (``tiny.make_root``)."""
from __future__ import annotations

from pathlib import Path

import pytest

from . import tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))
