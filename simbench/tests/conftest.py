import pytest
import torch


@pytest.fixture(autouse=True)
def few_threads():
    """One worker process of several: a few threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    from simbench.tests import tiny
    return tiny.make_root(tmp_path_factory.mktemp("simbench"))
