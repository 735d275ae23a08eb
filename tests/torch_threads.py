"""torch's CPU ops on one thread, for the port's test modules that run
the detector at frame sizes.

The suite runs one worker process a core, and a torch thread pool in
each worker spins against the others' (a 2 s detector call took 75 s
so, a 6 s ladder 85 s). A module takes the fixture by importing it and
naming it in ``pytestmark``::

    from torch_threads import torch_one_thread  # noqa: F401
    pytestmark = pytest.mark.usefixtures("torch_one_thread")
"""
from __future__ import annotations

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_torch_thread():
    """One torch thread for the block; the count before it after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def torch_one_thread():
    """One torch thread for the module's tests."""
    with one_torch_thread():
        yield
