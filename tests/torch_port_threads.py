"""The port's test files run torch with one intra-op thread: the default pool
of one thread per core spins against the other test workers' (the CLI files
ran ~7x slower beside them), and against JAX's own pool in the same worker.

    from torch_port_threads import one_intra_op_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """torch's intra-op pool at one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
