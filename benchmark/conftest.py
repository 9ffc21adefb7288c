"""The benchmark's own tests: CPU tests at small sizes, and ``card`` tests
that need a CUDA device (they skip without one; whether there is a card is
decided inside the fixture, never at import).

    python3 -m pytest benchmark -q              # here or on the card
"""

import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def small_cell(name: str, root=ROOT):
    """The cell ``name`` at a test's size: 32x32 images, batch 2."""
    from benchmark import manifest

    cell = manifest.cell(root, name)
    cell.config = dict(cell.config, image_size=32, calibration_images=4,
                       check_rows=2)
    cell.traffic = dict(cell.traffic, batch=2, pool_batches=3,
                        check_requests=2, warmup_requests=1)
    cell.reference = manifest.reference(root, cell.config["reference"])
    return cell
