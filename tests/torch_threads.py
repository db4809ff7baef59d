"""An autouse fixture for the port's test modules (import it by name):
at most 2 intra-op threads for torch while the module runs.  The suite
runs in several processes at once, and torch's default of one thread per
core makes them, and the JAX tests beside them, wait on each other.  It
changes nothing that the tests compute."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
