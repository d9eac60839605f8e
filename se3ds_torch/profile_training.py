"""Where a train step's time goes on the card (PyTorch profiler).

    python -m se3ds_torch.profile_training [--gin configs/lowres/lowres.gin]
        [--chunk 16] [--remat] [--steps 2] [--top 15]

Builds a recipe's trainer at full width from its gin file (lowres by
default: 256x128 panoramas; configs/highres/highres.gin: 1024x512; both
G gen_dims=128 ResNet-101, D dis_dims=128 n_dis=2 n_layers=6), float32
with TF32 convolutions, random weights from seed 0, `--chunk` examples
per chunk, activations rematerialised with `--remat`; warms up with two
`train_step`s on one synthetic batch, then profiles `--steps` more. A
chunk that does not fit raises the card's out-of-memory error: run one
process per chunk to find the largest that fits. Prints the host wall
and the device's busy time and idle share; for each part of the step
(the program's own spans `train.step.*` of `se3ds_torch.tracing`: the
D-only step, each D update, each backward, each clip, each Adam step,
the EMA) its calls, its host time and the device time of the kernels it
launched under the profiler (parts nest: a D update is inside the D-only
step), then each part's median host and device time over `--steps` more
steps without the profiler; the device time by kernel (top `--top`) and
the device operations per step; the peak device memory; the step's FLOPs
(`Trainer.step_flops`) and TFLOP/s by the wall; with the card's name and
power limit. Needs a CUDA card.
"""

import argparse
import os
import statistics
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from se3ds_torch import config as config_lib
from se3ds_torch import tracing
from se3ds_torch.train import state as state_lib
from se3ds_torch.train import trainer as trainer_lib

LOWRES_GIN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'lowres', 'lowres.gin')


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--gin', default=LOWRES_GIN)
  parser.add_argument('--chunk', type=int, default=16)
  parser.add_argument('--remat', action='store_true')
  parser.add_argument('--steps', type=int, default=2)
  parser.add_argument('--top', type=int, default=15)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('profile_training needs a CUDA card.')
  power = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  torch.backends.cudnn.allow_tf32 = True
  config_lib.parse_config_files_and_bindings([args.gin])
  with tempfile.TemporaryDirectory() as model_dir:
    trainer = config_lib.apply_config(
        'GAN', model_dir=model_dir, train_batch_size=args.chunk,
        remat=args.remat, device='cuda')
  state = trainer.create_state()
  batch = trainer.device_batch(next(trainer_lib.synthetic_batches(
      trainer.d_step_per_g_step * args.chunk, trainer.image_size, 0)))
  step = lambda: state_lib.train_step(state, batch, trainer.hp)
  for _ in range(2):
    step()
  torch.cuda.synchronize()

  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(args.steps):
      step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6

  cuda = torch.autograd.DeviceType.CUDA
  averages = prof.key_averages()
  labels = sorted({e.key for e in averages
                   if e.key.startswith('train.step')})
  # Device work only: kernels, memsets and copies, not the device-side
  # rows of ranges (the ranges above, the optimizer's own).
  events = [e for e in averages if e.device_type == cuda
            and e.self_device_time_total > 0 and e.key not in labels
            and not getattr(e, 'is_user_annotation', False)
            and not e.key.startswith('Optimizer.')]
  events.sort(key=lambda e: e.self_device_time_total, reverse=True)
  device_us = sum(e.self_device_time_total for e in events)
  print(power)
  print(f'{os.path.basename(args.gin)} at image {trainer.image_size}, '
        f'remat {args.remat}')
  print(f'{args.steps} steps of {2 * args.chunk} examples: wall '
        f'{wall_us / 1e3 / args.steps:.2f} ms/step, device busy '
        f'{device_us / 1e3 / args.steps:.2f} ms/step, idle share '
        f'{max(0.0, 1 - device_us / wall_us):.3f}')
  if not events:
    print('the profiler recorded no device time')
    return
  parts = {e.key: e for e in averages
           if e.key in labels and e.device_type != cuda}
  for label in labels:
    part = parts.get(label)
    if part is None:
      print(f'  {label}: not recorded')
      continue
    print(f'  {label}: {part.count / args.steps:.0f} calls/step, host '
          f'{part.cpu_time_total / 1e3 / args.steps:.2f} ms/step, device '
          f'{part.device_time_total / 1e3 / args.steps:.2f} ms/step')
  tracing.reset()
  for _ in range(args.steps):
    step()
  spans = tracing.snapshot()['spans']
  steps = tracing.count('train.steps')
  print(f'without the profiler, medians over {steps} steps '
        '(se3ds_torch.tracing):')
  for name, span in sorted(spans.items()):
    device = (f", device {statistics.median(span['device_ms']):.2f} ms"
              if span['device_ms'] else '')
    print(f"  {name}: {span['count'] / steps:.0f} calls/step, host "
          f"{statistics.median(span['host_ms']):.2f} ms{device}")
  print(f'{"device ms/step":>15} {"share":>7} {"calls":>6}  kernel')
  for e in events[:args.top]:
    print(f'{e.self_device_time_total / 1e3 / args.steps:15.3f} '
          f'{e.self_device_time_total / device_us:7.3f} {e.count:6d}  '
          f'{e.key[:90]}')
  print(f'device operations per step: '
        f'{sum(e.count for e in events) / args.steps:.0f}')
  print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}'
        ' GiB')
  flops = trainer.step_flops(batch)
  print(f'{flops:.6g} FLOPs per step (utils/flops.py): '
        f'{flops / (wall_us / args.steps) / 1e6:.2f} TFLOP/s by the wall')


if __name__ == '__main__':
  main()
