"""The one-thread fixture of the port's test files. Their tensors are small:
under the Tier-1 command's parallel workers torch's thread pool costs more
time than it saves. A test file takes it for each of its tests with

    from torch_one_thread import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
