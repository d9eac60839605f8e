"""Converts a released SE3DS TF checkpoint into the port's serving file
(port of the JAX package's `scripts/convert_tf_checkpoint.py`).

Takes a reference `tf.train.Checkpoint` bundle (the released `mp3d_ckpt`
/ `re10k_ckpt` format) and writes the file of
`train.checkpoints.save_ema_generator`, which
`SE3DSModel(SE3DSConfig(ckpt_path=...))` loads as it is. No TensorFlow is
needed: `train.tf_bundle` reads the bundle.

The template generator is built on the meta device, and the bundle's
tensors are read one at a time, so memory holds the converted branch
(~4.46 GB for the ema_generator at gen_dims 128, ResNet-101) and its
folded serving copy. Seconds, GB read and peak RSS are printed.

    python -m se3ds_torch.convert_tf_checkpoint --tf_ckpt /data/mp3d_ckpt \\
        --output /data/se3ds_mp3d.pt

    # The RE10K bundle: add --no_blurred_mask

The model flags default to the released grammar (image_height 512,
gen_dims 128, ResNet-101); change them only for other checkpoints.
"""

import argparse
import os
import resource
import sys
import time

import torch

from se3ds_torch.models import generator as generator_lib
from se3ds_torch.train import checkpoints
from se3ds_torch.train import tf_bundle
from se3ds_torch.train import tf_import


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--tf_ckpt', required=True,
                 help='TF checkpoint prefix (e.g. .../ckpt-100) or a '
                      'directory holding a `checkpoint` state file (the '
                      'extracted released tar).')
  p.add_argument('--output', required=True,
                 help='The serving file to write (must not exist).')
  p.add_argument('--root', default='ema_generator',
                 choices=['ema_generator', 'generator'],
                 help='The checkpoint branch to convert (serving restores '
                      'ema_generator).')
  p.add_argument('--image_height', type=int, default=512)
  p.add_argument('--gen_dims', type=int, default=128)
  p.add_argument('--z_dim', type=int, default=32)
  p.add_argument('--resnet_version', default='101')
  p.add_argument('--no_blurred_mask', action='store_true',
                 help='RE10K grammar: the generator input has no '
                      'blurred-mask channel.')
  return p.parse_args(argv)


def resolve_ckpt_prefix(path: str) -> str:
  """A checkpoint prefix, or the latest one of a directory."""
  if os.path.isdir(path):
    latest = tf_bundle.latest_checkpoint(path)
    if latest is None:
      raise SystemExit(
          f'{path} is a directory but holds no TF checkpoint state (no '
          '`checkpoint` file naming an existing bundle). Pass the prefix, '
          f'e.g. {path}/ckpt-100.')
    return latest
  return path


def peak_rss() -> str:
  """This process's peak resident set: Linux's VmHWM, which starts
  afresh at exec; where /proc has none, `ru_maxrss`, which also holds the
  peak of the process that started this one."""
  try:
    with open('/proc/self/status') as f:
      for line in f:
        if line.startswith('VmHWM:'):
          return f'{int(line.split()[1]) * 1024 / 1e9:.2f} GB (VmHWM)'
  except OSError:
    pass
  maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
  return (f'{maxrss:.2f} GB (ru_maxrss: the starting process\'s peak '
          'included)')


def main(argv=None) -> int:
  args = parse_args(argv)
  if os.path.exists(args.output):
    raise SystemExit(f'--output {args.output} already exists; refusing to '
                     'overwrite.')
  ckpt_prefix = resolve_ckpt_prefix(args.tf_ckpt)
  print(f'[convert] TF checkpoint: {ckpt_prefix}')
  with torch.device('meta'):
    model = generator_lib.ResNetGenerator(
        gen_dims=args.gen_dims, z_dim=args.z_dim,
        resnet_version=args.resnet_version,
        use_blurred_mask=not args.no_blurred_mask, spectral_fold=False)
  n_values = sum(t.numel() for t in model.state_dict().values())
  print(f'[convert] template: {n_values:,} values (R{args.resnet_version}, '
        f'gen_dims={args.gen_dims}, {2 * args.image_height}x'
        f'{args.image_height})')

  t0 = time.perf_counter()
  state = tf_import.convert_tf_checkpoint(ckpt_prefix, model, root=args.root)
  seconds = time.perf_counter() - t0
  gb = sum(t.numel() * t.element_size() for t in state.values()) / 1e9
  print(f'[convert] every leaf resolved: {gb:.3f} GB read in {seconds:.2f} s '
        f'({gb / seconds:.3f} GB/s)')
  model.load_state_dict(state, assign=True)
  del state
  t0 = time.perf_counter()
  checkpoints.save_ema_generator(args.output, model)
  peak = peak_rss()
  print(f'[convert] wrote {os.path.abspath(args.output)} in '
        f'{time.perf_counter() - t0:.2f} s')
  print(f'[convert] peak RSS {peak}')
  print('[convert] load with: SE3DSConfig(ckpt_path='
        f'{os.path.abspath(args.output)!r}, image_height={args.image_height}, '
        f'gen_dims={args.gen_dims}, resnet_version={args.resnet_version!r}, '
        f'use_blurred_mask={not args.no_blurred_mask})')
  return 0


if __name__ == '__main__':
  sys.exit(main())
