"""Where a served frame's time goes on the card (PyTorch profiler).

    python -m se3ds_torch.profile_serving [--frames 2] [--top 15] [--eager]

Builds the full-width serving model (1024x512, gen_dims=128, ResNet-101,
bf16, random weights from seed 0) with a ring memory of RING_FRAMES
frames, adds one synthetic pano, warms up with `add_preds_to_memory=True`
frames until every step splats the whole ring (one program key) and that
key has been captured, then profiles `--frames` more. By default the
steps replay the model's captured CUDA graph; `--eager` builds the model
with `cuda_graphs=False` and profiles the same steps run op by op.
Prints the device time by kernel (top `--top`), the device operations
(kernels, memsets, copies) per frame, the 'fast' splat kernels' share,
and the device's idle share of the profiled wall time; the set-up's
spans of `se3ds_torch.tracing` (the build, the memory write, each key's
eager run and capture) and its counters; then, over `--frames` more
steps without the profiler, the median host and device time of each span
of the serving API (`serve.*`: the step, its upload, replay and
copy-out) and its counters; with the card's name and power limit. Needs
a CUDA card. Run as a file with PYTHONPATH=<tree> it profiles that
tree's `se3ds_torch`.
"""

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from se3ds_torch import tracing
from se3ds_torch.models import inference
from se3ds_torch.models import model_config

# A ring memory: after RING_FRAMES + 1 warm-up steps every step has the
# same key (the whole ring splatted) and replays its captured graph.
RING_FRAMES = 4


def _pano(height):
  rs = np.random.RandomState(0)
  rows = np.linspace(0, np.pi, height)[:, None]
  cols = np.linspace(0, 2 * np.pi, 2 * height)[None, :]
  depth = (0.15 + 0.1 * np.abs(np.cos(rows)) + 0.05 * np.sin(3 * cols)
           + rs.uniform(0, 0.01, (height, 2 * height)))
  rgb = np.repeat(127 + 100 * np.sin(cols * 5 + rows * 3)[..., None], 3, -1)
  sem = (cols * 6 / (2 * np.pi)).astype(np.int64) % 41 + 1 + 0 * rows
  return (rgb.astype(np.int32)[None], sem.astype(np.int32)[None, ..., None],
          depth.astype(np.float32)[None])


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--frames', type=int, default=2)
  parser.add_argument('--top', type=int, default=15)
  parser.add_argument('--eager', action='store_true',
                      help='run the steps op by op (cuda_graphs=False) '
                      'instead of replaying their captured graph')
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('profile_serving needs a CUDA card.')
  power = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  cfg = model_config.SE3DSConfig(
      ckpt_path=None, image_height=512, gen_dims=128, resnet_version='101',
      compute_dtype='bfloat16', memory_frames=RING_FRAMES,
      memory_mode='ring', splat_mode='fast')
  model = inference.SE3DSModel(
      cfg, generator=torch.Generator(device='cuda').manual_seed(0),
      cuda_graphs=not args.eager)
  model.add_to_memory(*_pano(512), np.zeros((1, 3), np.float32))
  step = lambda i: model(np.array([[0.2 * (i + 1), 0.1, 0.0]], np.float32),
                         add_preds_to_memory=True)
  warmup = RING_FRAMES + 1
  for i in range(warmup):
    step(i)
  torch.cuda.synchronize()
  replays = tracing.count('serve.replays')

  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for i in range(args.frames):
      step(warmup + i)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6

  averages = prof.key_averages()
  cuda = torch.autograd.DeviceType.CUDA
  replays = tracing.count('serve.replays') - replays
  # Device work only, not the device-side rows of the program's spans.
  events = [e for e in averages if e.device_type == cuda
            and e.self_device_time_total > 0
            and not e.key.startswith('serve.')]
  events.sort(key=lambda e: e.self_device_time_total, reverse=True)
  device_us = sum(e.self_device_time_total for e in events)
  print(power)
  if model.graphs:
    print(f'graph replays: {replays} of the '
          f'{args.frames} profiled steps ({len(model.graphs.graphs)} graphs '
          'captured)')
  else:
    print(f'eager: {model.uncaptured}')
  if not events:
    # The profiler saw no device activity: time the frames with events.
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(args.frames):
      step(warmup + args.frames + i)
    end.record()
    end.synchronize()
    print(f'profiler recorded no device time; CUDA events: '
          f'{start.elapsed_time(end) / args.frames:.3f} ms/frame')
    return
  print(f'{args.frames} frames: wall {wall_us / 1e3:.3f} ms, device busy '
        f'{device_us / 1e3:.3f} ms, idle share '
        f'{max(0.0, 1 - device_us / wall_us):.3f}')
  print(f'{"device ms/frame":>16} {"share":>7} {"calls":>6}  kernel')
  for e in events[:args.top]:
    print(f'{e.self_device_time_total / 1e3 / args.frames:16.4f} '
          f'{e.self_device_time_total / device_us:7.3f} {e.count:6d}  '
          f'{e.key[:90]}')
  print(f'device operations per frame: '
        f'{sum(e.count for e in events) / args.frames:.1f}')
  splat_us = sum(e.self_device_time_total for e in events
                 if 'splat_fast' in e.key or 'resolve_fast' in e.key)
  print(f'splat_fast kernels: {splat_us / 1e3 / args.frames:.4f} ms/frame, '
        f'share {splat_us / device_us:.5f}')
  setup = tracing.snapshot()
  parts = [f"{name} {sum(span['host_ms']):.1f} ms ({span['count']})"
           for name, span in sorted(setup['spans'].items())
           if name.startswith(('serve.build', 'serve.add'))
           or name.endswith(('.eager', '.capture'))]
  counters = [f'{name} {n}' for name, n in sorted(setup['counters'].items())]
  print(f"set-up (se3ds_torch.tracing): {', '.join(parts)}; "
        f"{', '.join(counters)}")
  tracing.reset()
  for i in range(args.frames):
    step(warmup + args.frames + i)
  torch.cuda.synchronize()
  snapshot = tracing.snapshot()
  print(f'without the profiler, medians over {args.frames} steps '
        '(se3ds_torch.tracing):')
  for name, span in sorted(snapshot['spans'].items()):
    device = (f", device {statistics.median(span['device_ms']):.3f} ms"
              if span['device_ms'] else '')
    print(f"  {name}: {span['count']} calls, host "
          f"{statistics.median(span['host_ms']):.3f} ms{device}")
  print('  counters: ' + ', '.join(
      f'{name} {n}' for name, n in sorted(snapshot['counters'].items())))


if __name__ == '__main__':
  main()
