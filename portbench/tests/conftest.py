"""Shared fixtures of the benchmark's own tests (CPU unless marked)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SMALL_RAYS = {"width": 16, "height": 16, "spread": 0.8,
              "position": [0.0, 0.0, -3.3]}
# each cell at a size a CPU test holds: the same path, fewer rays
SMALL = {
    "cornell_box.fit": dict(rays=SMALL_RAYS, check_steps=0,
                            reference_block=128, count_samples=4),
    "cornell_box.render": dict(rays=SMALL_RAYS, check_calls=0),
    "cornell_box.observe": dict(pixels=[16, 16], spp=4, tile_size=64,
                                check_passes=0, check_tiles=1),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is there (decided at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
