"""Starts a training or a continuous-eval job of the PyTorch port.

    python -m se3ds_torch.main --mode TRAIN \
        --gin_config configs/lowres/lowres.gin --model_dir /tmp/se3ds

The flags of the JAX package's `main.py`: `--model_dir` (or `--workdir`),
`--mode` TRAIN, TEST or TEST_UNSEEN in either case (TEST_UNSEEN
evaluates the 'val_unseen' split), repeated `--gin_config` files and
`--gin_bindings`. `--device` picks where it runs: the CUDA card by
default (it raises where there is none), or 'cpu'.

Data-parallel training runs one process per card under torchrun, which
sets `WORLD_SIZE`, `RANK` and `LOCAL_RANK` (`parallel.mesh`):

    torchrun --nproc_per_node 1 -m se3ds_torch.main --mode TRAIN \
        --gin_config configs/highres/highres.gin --model_dir /tmp/se3ds \
        --gin_bindings "GAN.remat = True"

`train_batch_size` stays the global batch; each rank steps on its share.
TEST under torchrun rolls out each rank's share of every eval batch and
rank 0 writes the scores. Without torchrun the job runs alone (world 1).
"""

from __future__ import annotations

import argparse
import enum
import logging
import os
import sys
from typing import Optional, Sequence

import torch.distributed as dist

from se3ds_torch import config as config_lib
from se3ds_torch.train import trainer  # noqa: F401 (registers GAN, ...)


class Mode(enum.Enum):
  TRAIN = 'TRAIN'
  TEST = 'TEST'
  TEST_UNSEEN = 'TEST_UNSEEN'


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(description='SE3DS PyTorch launcher')
  parser.add_argument('--model_dir', '--workdir', dest='model_dir',
                      required=True, help='Directory to save the model in.')
  parser.add_argument('--mode', default='TRAIN',
                      choices=[m.value for m in Mode] + [
                          m.value.lower() for m in Mode])
  parser.add_argument('--gin_config', action='append', default=[],
                      help='Paths to gin config files.')
  parser.add_argument('--gin_bindings', action='append', default=[],
                      help='Individual gin bindings.')
  parser.add_argument('--device', default=None,
                      help="Where to run: 'cuda' (the default; raises "
                           "without a card) or 'cpu'.")
  return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
  """Runs one job; `argv` as on the command line (default sys.argv).

  Each call starts from a clear config, so jobs can run one after
  another in one process.
  """
  args = parse_args(argv)
  logging.basicConfig(level=logging.INFO)
  config_lib.clear_config()
  config_lib.parse_config_files_and_bindings(args.gin_config,
                                             args.gin_bindings)
  mode = Mode(args.mode.upper())
  overrides = {'test_split': 'val_unseen'} if mode is Mode.TEST_UNSEEN else {}
  model = config_lib.apply_config('GAN', model_dir=args.model_dir,
                                  device=args.device, **overrides)
  logging.getLogger('se3ds_torch').info(
      '%s on %s, rank %d of %d', mode.value, model.device, model.data.rank,
      model.data.world_size)
  try:
    if mode is Mode.TRAIN:
      model.train()
    else:
      model.test()
  finally:
    if 'WORLD_SIZE' in os.environ and dist.is_initialized():
      dist.destroy_process_group()  # the group torchrun's job formed
  return 0


if __name__ == '__main__':
  sys.exit(main())
