"""Times the splat stage of a served frame and of a rollout frame.

    PYTHONPATH=<tree> python3 se3ds_torch/splat_stage.py

Times, on one card, the stage from the world memory to the two guidance
images of whichever `se3ds_torch` the import path finds first, through
its public geometry API: `project_memory_equirect` where the tree has
it, else the translated copy through `project_feats_to_equirectangular`
(the form the main path took before it). So one call can time two trees
of the repo in turns (unpack the other one with `git archive`).

- Serving: the semantic (C=1, no depth) and the RGB (C=3, pole-compact)
  clouds of a two-frame memory, 1024x512, batch 1, 'fast' splat.
- Rollout: the RGB cloud of a three-frame memory (the rollout's largest
  frame), batch 8, the exact splat ('sorted').

Prints one JSON line: the card's name and power limit, then per stage
the median of CUDA-event timings around one call (`ms`), the device time
per call from the profiler (`device_ms`, no host gaps) and the device
operations (kernels and memsets) per call. Needs a CUDA card.
"""

import json
import statistics
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from se3ds_torch import constants
from se3ds_torch.models import inference
from se3ds_torch.ops import geometry

H, W = 512, 1024


def _pano(seed, batch):
  rs = np.random.RandomState(seed)
  rows = np.linspace(0, np.pi, H)[:, None]
  cols = np.linspace(0, 2 * np.pi, W)[None, :]
  depth = 0.15 + 0.1 * np.abs(np.cos(rows)) + 0.05 * np.sin(3 * cols)
  depth = depth + rs.uniform(0, 0.01, (batch, H, W))
  depth[rs.rand(batch, H, W) < 0.01] = 0.0
  rgb = (127 + 100 * np.sin(cols * 5 + rows * 3)[..., None]
         + rs.randint(-20, 20, (batch, H, W, 3)))
  sem = np.broadcast_to((cols * 6 / (2 * np.pi)).astype(np.int64) % 41 + 1,
                        (batch, H, W))[..., None]
  return (torch.from_numpy(np.clip(rgb, 0, 255).astype(np.int32)).cuda(),
          torch.from_numpy(sem.astype(np.int32)).cuda(),
          torch.from_numpy(depth.astype(np.float32)).cuda())


def _memory(batch, frames, pole_compact):
  rgb_points = (inference.pole_valid_rows(H)[1] - inference.pole_valid_rows(
      H)[0]) * W if pole_compact else H * W
  memory = inference.init_memory(batch, frames * H * W, frames * rgb_points,
                                 device=torch.device('cuda'))
  for f in range(frames):
    position = torch.tensor([[0.3 * f, 0.1, 0.0]] * batch, device='cuda')
    inference.memory_add_pano(
        memory, *_pano(f, batch), position, constants.DEPTH_SCALE,
        mask_blurred=True, pole_compact=pole_compact, write_slot=f)
  return memory


def _splat(feats, xyz, offset, void, mode, need_depth=True):
  if hasattr(geometry, 'project_memory_equirect'):
    return geometry.project_memory_equirect(
        feats, xyz, offset, H, W, void, constants.DEPTH_SCALE, mode,
        need_depth=need_depth)
  return geometry.project_feats_to_equirectangular(
      feats, xyz - offset[..., None], H, W, void, constants.DEPTH_SCALE,
      mode)


def _time(fn, reps=50):
  for _ in range(3):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  events = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
  return {'ms': statistics.median(times),
          'device_ms': sum(e.self_device_time_total for e in events)
                       / reps / 1e3,
          'device_ops': sum(e.count for e in events) / reps}


def main():
  if not torch.cuda.is_available():
    raise SystemExit('splat_stage needs a CUDA card.')
  power = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  serving = _memory(1, 2, pole_compact=True)
  offset = torch.tensor([[0.5, 0.0, 0.0, 0.0]], device='cuda')

  def served_frame():
    _splat(serving.feats, serving.coords, offset,
           constants.INVALID_SEM_VALUE, 'fast', need_depth=False)
    _splat(serving.rgb, serving.rgb_coords, offset,
           constants.INVALID_RGB_VALUE, 'fast')

  rollout = _memory(8, 3, pole_compact=False)
  offsets = torch.tensor([[0.7, 0.2, 0.0, 0.0]] * 8, device='cuda')
  rollout_frame = lambda: _splat(rollout.rgb, rollout.rgb_coords, offsets,
                                 constants.INVALID_RGB_VALUE, 'sorted')
  print(json.dumps({
      'card': power, 'api': ('project_memory_equirect'
                             if hasattr(geometry, 'project_memory_equirect')
                             else 'project_feats_to_equirectangular'),
      'served_frame': _time(served_frame),
      'rollout_frame': _time(rollout_frame, reps=20)}))


if __name__ == '__main__':
  main()
