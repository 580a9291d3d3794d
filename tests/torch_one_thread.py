"""A module-scoped autouse fixture that runs a port test file's torch CPU
work on one intra-op thread, restored after the module.

The port's tests run small shapes (batch 2-8, 32² images), where one
thread does their ops about as fast as eight alone; beside other pytest
workers, eight threads each oversubscribe the cores and the file runs
several times slower. Import it into a test module to apply it there:

    from torch_one_thread import one_intra_op_thread  # noqa: F401

A file whose results sit on a knife-edge of summation order (one
intra-op thread changes torch's reduction order) keeps the default.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
