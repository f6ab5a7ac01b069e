"""pytest settings of the benchmark's own tests (run them with
`python -m pytest benchmark/tests -q` from the repository root). Tests
marked `card` need an NVIDIA card and skip without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100")
    return torch.device("cuda:0")


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory):
    """A copy of the checkout that also declares extra_cells.json's cells."""
    from benchmark.tests.bench_util import checkout

    return checkout(tmp_path_factory.mktemp("checkout"))
