"""The benchmark's own tests: `python -m pytest portbench -q` on the CPU.
Tests marked `chip` need an NVIDIA GPU and skip without one; on the card,
`python -m pytest portbench -q -m chip`."""

import pytest
import torch


def pytest_configure(config):
  config.addinivalue_line(
      'markers', 'chip: needs an NVIDIA GPU (skips without one)')


@pytest.fixture
def cuda():
  """The card, or a skip where there is none."""
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  return torch.device('cuda')
