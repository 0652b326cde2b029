"""Set-up shared by the port's CPU test modules that run its models."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the importing module's tests run (restored
    after). The models here are tiny; beside the other test workers torch's
    default threads oversubscribe the cores, and a tiny pretrain CLI run then
    took 152 s instead of 29 s. Runs that a test compares share the setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
