"""The port's tests' one-thread fixture. A test module takes it with

    from _torch_threads import _one_torch_thread  # noqa: F401

(pytest puts `tests/`, which is not a package, on `sys.path`; a `tests`
package installed elsewhere would shadow `tests._torch_threads`).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: these tensors are tiny, and beside
    the suite's other workers torch's spinning thread pool costs far more
    than it saves (an SVGP fit of 200 steps: ~250 s with 8 threads, ~1 s
    with one, six processes on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
