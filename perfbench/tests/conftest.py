"""Shared fixtures of the benchmark's CPU tests."""

from __future__ import annotations

import pytest

from perfbench.tests import tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with the tiny cells added by files."""
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))
