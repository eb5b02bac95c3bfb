import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny runs are thousands of small ops: one thread each, so the
    test workers running beside them are not starved."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
