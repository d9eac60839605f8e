"""Converts Keras InceptionV3 weights (.h5) into the port's FID extractor
state dict (port of the JAX package's `scripts/convert_inception.py`).

Absolute FID needs the ImageNet weights, which the reference loads as
the Keras bundle; a user brings the file. Reading it needs h5py, so
convert it once on a machine that has h5py:

    python -m se3ds_torch.convert_inception \\
        --h5 /path/to/inception_v3_weights_tf_dim_ordering_tf_kernels.h5 \\
        --out /path/to/inception_v3.pt --verify

and evaluate with the written file anywhere, h5py or not:

    --gin_bindings="inception_model.checkpoint_path='/path/to/inception_v3.pt'"
"""

import argparse
import os
import sys

import numpy as np
import torch

from se3ds_torch.eval import inception


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--h5', required=True,
                      help='Keras InceptionV3 weights .h5 file')
  parser.add_argument('--out', required=True,
                      help='Output file (torch.save of the state dict)')
  parser.add_argument('--verify', action='store_true',
                      help='Reload the written file, compare, and check '
                           'that the softmax sums to 1')
  args = parser.parse_args(argv)

  state = inception.load_keras_weights(args.h5)
  out = os.path.abspath(args.out)
  torch.save(state, out)
  print(f'Saved the converted InceptionV3 state dict to {out}')

  if args.verify:
    restored = inception.inception_model(checkpoint_path=out)
    for key, value in restored.state_dict().items():
      if not torch.equal(value, state[key]):
        raise AssertionError(f'{key} differs after the round trip')
    images = torch.from_numpy(
        np.random.RandomState(0).rand(2, 299, 299, 3).astype(np.float32))
    pool, preds = inception.get_inception(images, restored)
    if tuple(pool.shape) != (2, inception.POOL_DIM):
      raise AssertionError(f'pool shape {tuple(pool.shape)}')
    if not torch.allclose(preds.sum(-1), torch.ones(2), atol=1e-4):
      raise AssertionError(f'softmax sums {preds.sum(-1).tolist()}')
    print('Round-trip verification OK.')
  return 0


if __name__ == '__main__':
  sys.exit(main())
