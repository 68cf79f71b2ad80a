import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Hold torch at two intra-op threads while a file's tests run, so the
    driver's workers do not each start one per core."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    """Skips where there is no card; the card's tests run on the chip."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")
