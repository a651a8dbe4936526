"""Shared set-up of annbench's tests: the repository's root on the path, and
the tiny sizes at which the CPU runs a cell end to end."""

import sys
from pathlib import Path

import pytest
import torch

# the CPU runs of several test workers share the machine's cores
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a cell's configuration at a size the CPU runs in seconds (every width cut: tests only)
TINY = {"n_items": 2000, "dimensions": 32, "query_pool": 384, "map_size_gib": 0.25}


@pytest.fixture
def cuda_device():
    """The card, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
