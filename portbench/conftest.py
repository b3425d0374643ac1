"""The benchmark's CPU tests run small models: one intra-op thread each, so
that the parallel workers of the suite do not oversubscribe the cores."""

import pytest


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
