"""A fixture for the port's tests: torch on one intra-op thread.

The tier-1 command runs the suite in 6 processes on the machine's cores.
torch's CPU ops default to one OpenMP thread per core in every process, and
on golden-sized tensors the oversubscribed thread teams spend their time
waiting on one another: on an 8-core host, three smooth_fastq calls on
synth_long took 216 s in each of 6 concurrent processes, and 0.25 s with one
thread each.  A test module imports the fixture to take it (it is
autouse):

    from torch_cpu import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
