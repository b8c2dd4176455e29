"""The benchmark's CPU tests. Run from the repository's root with
``python -m pytest bench/tests`` (the repository's own test run collects
``tests/`` only)."""
from __future__ import annotations

from pathlib import Path

import pytest

from bench_helpers import make_tree


@pytest.fixture(scope="session")
def tree(tmp_path_factory) -> Path:
    return make_tree(tmp_path_factory.mktemp("bench_tree"))
