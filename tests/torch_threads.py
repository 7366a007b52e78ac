"""One torch thread for each port test on the CPU.

The suite runs in several xdist workers on one machine, and torch starts
each worker with an intra-op thread for every core: six workers
oversubscribe the box, and a test that times its own calls (the bench's
slopes) or trains a few epochs runs many times slower than on one thread.
A port test file takes the fixture by importing it::

    from torch_threads import one_torch_thread  # noqa: F401

It is autouse: every test of that file runs on one thread, and the count
is restored after it.  Spawned rank processes set their own
(``torch_ranks``).  This module imports no JAX.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
