"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the root of the repository. Tests marked `cuda` need a CUDA card and skip
without one; run them there with `-m cuda`."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# Sizes small enough for the CPU, with every kind of layer and path.
TINY_SERVE = dict(image_height=32, gen_dims=4, resnet_version='tiny',
                  memory_frames=3)
TINY_TRAIN = {'GAN.image_size': 32, 'GAN.train_batch_size': 2,
              'image_models.ResNetGenerator.gen_dims': 4,
              'image_models.ResNetGenerator.resnet_version': "'tiny'",
              'image_models.SNMultiScaleDiscriminator.dis_dims': 4,
              'image_models.SNMultiScaleDiscriminator.n_layers': 3}


def pytest_configure(config):
  config.addinivalue_line('markers', 'cuda: needs a CUDA card')


@pytest.fixture
def cuda_card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')


@pytest.fixture(autouse=True)
def few_threads():
  import torch
  threads = torch.get_num_threads()
  torch.set_num_threads(min(threads, 4))
  yield
  torch.set_num_threads(threads)


def tiny(name: str) -> harness.Cell:
  """The cell `name` at a size the CPU runs in seconds."""
  cell = harness.find_cell(name)
  config = dict(cell.config)
  if 'model' in config:
    config['model'] = dict(config['model'], **TINY_SERVE)
  else:
    keep = [line for line in config['gin']
            if line.split('=')[0].strip() not in TINY_TRAIN]
    config['gin'] = keep + [f'{k} = {v}' for k, v in TINY_TRAIN.items()]
  return cell._replace(config=config)


def run_tiny(name: str, seconds: float = 1.0, seed: int = 5123456789,
             control: bool = False) -> harness.Outcome:
  cell = tiny(name)
  return harness.driver(cell).run(cell, seed, seconds, False, 'cpu',
                                  time.perf_counter(), control=control)


def correct(cell: harness.Cell, outcome: harness.Outcome) -> bool:
  return all(value <= limit for value, limit in outcome.checks.values())
