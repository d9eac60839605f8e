"""Drives the PyTorch/CUDA port of SE3DS (serving and FID eval) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:
  1. Device and build: the card's name and power limit, then every CUDA
     source of se3ds_torch built with nvcc (one process per source).
  2. Kernel against its plain version: the CUDA splat and its PyTorch
     version on the same card tensors, at full width (512x1024 pixels,
     ~1.05M points with 1 channel, ~0.79M points with 3 channels, batch
     1 and 2) and on edge cases. Results must be torch.equal. Times the
     kernel and the plain version.
  3. Small input against the CPU path: the same weights and pano through
     SE3DSModel on the card and on the CPU (plain versions).
  4. Full-width serving: SE3DSModel at 1024x512, gen_dims=128, ResNet-101,
     bf16, from a seeded generator; add_to_memory, three
     add_preds_to_memory=True calls and one predict_trajectory of T=3.
     Checks shapes, dtypes, finite values, proj_mask coverage in (0, 1)
     and exactly 2 'fast' splat launches per served frame (and no exact
     one), then holds the kernel against its plain version on the main
     path's own memory.
  5. Exact kernel against its plain version: the exact CUDA splat (two
     passes) and its PyTorch version, torch.equal on depth and features,
     on edge cases (with output void 0 and -1, negative features, points
     beyond depth_scale) and on collision-heavy full-width clouds (~0.5M,
     1.05M and 2.1M points, C=3 and C=1, batch 1 and 8). Times the
     kernel, the wrapper and the plain version.
  6. Full-width FID eval: ResNetGenerator(gen_dims=128, ResNet-101) in
     bf16 from a seeded generator, 1024x512, batch 8, T=4, the exact
     splat: rollout_generated (shapes, finite values, proj_mask coverage,
     exactly 2 exact launches per frame and no 'fast' one), then
     EvalMetric(eval_num=8, batch_size=8, avg_num=1).calculate_fid_score
     (finite FID, RMSE and IS); the kernel against its plain version on
     the rollout's own splat inputs; the test config's rollout on the
     card against the CPU.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 512, 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SPLAT_REPLACES = 'se3ds_tpu/ops/splat_pallas.py:87'
EXACT_REPLACES = 'se3ds_tpu/ops/splat_pallas.py:204'
EVAL_BATCH, EVAL_FRAMES = 8, 4  # one card's share of highres test_batch_size


START = time.perf_counter()


def log(*args):
  print(*args, flush=True)


def card_name_and_power():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60,
      check=True)
  return out.stdout.strip().splitlines()[0]


def sync():
  torch.cuda.synchronize()


def time_ms(fn, reps, warmup=2):
  """Median over `reps` runs of fn's device time, in ms (CUDA events)."""
  for _ in range(warmup):
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
  return statistics.median(times)


def equal_or_raise(name, kernel_outs, plain_outs):
  """Max |d| between a kernel's outputs and its plain version's; raises
  unless every pair is torch.equal."""
  sync()
  err = max((float((k - p).abs().max())
             for k, p in zip(kernel_outs, plain_outs) if k.numel()),
            default=0.0)
  if not all(torch.equal(k, p) for k, p in zip(kernel_outs, plain_outs)):
    raise AssertionError(f'{name}: kernel != plain version (max |d| {err})')
  return err


def synthetic_pano(height, seed):
  """An RGB-D room pano: smooth depth, textured RGB, class stripes."""
  rs = np.random.RandomState(seed)
  w = 2 * height
  rows = np.linspace(0, np.pi, height)[:, None]
  cols = np.linspace(0, 2 * np.pi, w)[None, :]
  depth = 0.15 + 0.1 * np.abs(np.cos(rows)) + 0.05 * np.sin(3 * cols)
  depth = depth + rs.uniform(0, 0.01, (height, w))
  depth[rs.rand(height, w) < 0.01] = 0.0  # holes
  rgb = (127 + 100 * np.sin(cols * 5 + rows * 3)[..., None]
         + rs.randint(-20, 20, (height, w, 3)))
  sem = ((cols * 6 / (2 * np.pi)).astype(np.int64) % 41 + 1) + 0 * rows
  return (np.clip(rgb, 0, 255).astype(np.int32)[None],
          sem.astype(np.int32)[None, ..., None],
          depth.astype(np.float32)[None])


def view_clouds(batch, frames, seed, device, compact=True):
  """Full-width splat inputs made by the port's own geometry: `frames`
  panos per batch element unprojected and seen from a shifted pose. With
  `compact` the RGB cloud keeps only the rows mask_pano leaves."""
  from se3ds_torch import constants
  from se3ds_torch.models import inference
  from se3ds_torch.ops import geometry
  sem_xyz, sem_f, rgb_xyz, rgb_f = [], [], [], []
  r0, r1 = inference.pole_valid_rows(H)
  for b in range(batch):
    parts = ([], [], [], [])
    for f in range(frames):
      rgb, sem, depth = synthetic_pano(H, seed + 10 * b + f)
      rgb = geometry.mask_pano(torch.from_numpy(rgb).to(device),
                               masked_region_value=-1)
      depth = torch.from_numpy(depth).to(device)
      pos = torch.tensor([[0.3 * f, 0.1 * b, 0.0, 0.0]], device=device)
      xyz, feats = geometry.equirectangular_to_pointcloud(
          torch.from_numpy(sem[..., 0]).to(device), depth,
          constants.INVALID_SEM_VALUE, constants.DEPTH_SCALE)
      rxyz, rfeats = geometry.equirectangular_to_pointcloud(
          rgb, depth, constants.INVALID_RGB_VALUE, constants.DEPTH_SCALE,
          interpolation_method='bilinear')
      if compact:
        rxyz = rxyz.reshape(1, 4, H, W)[:, :, r0:r1].reshape(1, 4, -1)
        rfeats = rfeats.reshape(1, H, W, 3)[:, r0:r1].reshape(1, -1, 3)
      parts[0].append(xyz + pos[..., None])
      parts[1].append(feats[..., None].float())
      parts[2].append(rxyz + pos[..., None])
      parts[3].append(rfeats)
    sem_xyz.append(torch.cat(parts[0], -1))
    sem_f.append(torch.cat(parts[1], 1))
    rgb_xyz.append(torch.cat(parts[2], -1))
    rgb_f.append(torch.cat(parts[3], 1))
  target = torch.tensor([[0.2, -0.1, 0.05, 0.0]], device=device)
  view = lambda xyz: geometry.equirect_view_coords(
      torch.cat(xyz) - target[..., None])
  return [(view(sem_xyz), torch.cat(sem_f), float(constants.INVALID_SEM_VALUE)),
          (view(rgb_xyz), torch.cat(rgb_f), float(constants.INVALID_RGB_VALUE))]


def edge_clouds(device):
  """Empty, all-invalid, z <= 0, far out of range and void features."""
  rs = np.random.RandomState(7)
  m = 4096
  z = rs.uniform(0.1, 25, m).astype(np.float32)
  x = (rs.uniform(-1.2, 1.2, m) * z).astype(np.float32)
  y = (rs.uniform(-1.2, 1.2, m) * z).astype(np.float32)
  base = np.stack([x, y, z, np.ones_like(z)])[None]
  feats = rs.randint(0, 256, (1, m, 3)).astype(np.float32)
  cases = {'empty': (np.zeros((1, 4, 0), np.float32),
                     np.zeros((1, 0, 3), np.float32))}
  behind = base.copy()
  behind[:, 2] = -np.abs(behind[:, 2])
  behind[:, 2, ::7] = 0.0
  cases['z<=0'] = (behind, feats)
  far = base.copy()
  far[:, 0, ::2] = 1e30
  far[:, 1, 1::2] = -1e30
  far[:, 2, ::5] = 1e30
  cases['far out of range'] = (far, feats)
  void = feats.copy()
  void[:, ::3, 1] = -1.0
  cases['void features'] = (base, void)
  cases['all invalid'] = (behind, np.full_like(feats, -1.0))
  mixed = base.copy()
  mixed[:, 2, ::4] = 20.0  # depth_scale: the bucket edge
  cases['mixed edges'] = (mixed, void)
  return {k: (torch.from_numpy(c).to(device), torch.from_numpy(f).to(device))
          for k, (c, f) in cases.items()}


def splat_bytes(coords, feats):
  """Bytes the splat must move: x, y, z and the features of each point
  read once, the two 4-byte per-pixel buffers written once."""
  batch, _, m = coords.shape
  return batch * m * (12 + 4 * feats.shape[-1]) + batch * H * W * 8


def phase_kernel_parity(splat_cuda, power):
  log('== phase 2: CUDA splat against its plain version ==')
  device = torch.device('cuda')
  max_err = 0.0

  def compare(name, coords, feats, void, height=H, width=W):
    nonlocal max_err
    plain = splat_cuda.splat_fast_plain(coords, feats, height, width, 20.0,
                                        void)
    max_err = max(max_err, equal_or_raise(name, splat_cuda.splat_fast(
        coords, feats, height, width, 20.0, void), plain))
    log(f'  {name}: equal ({coords.shape[-1]} points, '
        f'{int((plain[1] != 0).sum())} pixels hit)')

  for name, (coords, feats) in edge_clouds(device).items():
    compare(name, coords, feats, -1.0, 64, 128)

  timings = {}
  for batch in (1, 2):
    clouds = view_clouds(batch, frames=2, seed=batch, device=device)
    for (coords, feats, void), kind in zip(clouds, ('semantic', 'rgb')):
      name = f'{kind} C={feats.shape[-1]} batch {batch}'
      compare(name, coords, feats, void)
      # The kernel alone, into buffers initialised once (min and max are
      # idempotent), and the wrapper the main path calls, which also
      # fills both buffers and widens the keys to int64.
      coords_k, feats_k = splat_cuda.check_inputs(coords, feats, H, W)
      zbuf = torch.full((batch, H * W), 20.0, device=device)
      pbuf = torch.zeros((batch, H * W), dtype=torch.int32, device=device)
      kernel_ms = time_ms(lambda: splat_cuda.launch_splat_fast(
          coords_k, feats_k, H, W, 20.0, void, zbuf, pbuf), reps=50)
      wrapper_ms = time_ms(lambda: splat_cuda.splat_fast(
          coords, feats, H, W, 20.0, void), reps=50)
      plain_ms = time_ms(lambda: splat_cuda.splat_fast_plain(
          coords, feats, H, W, 20.0, void), reps=10)
      bound_ms = splat_bytes(coords, feats) / HBM_BYTES_PER_S * 1e3
      timings[(kind, batch)] = (kernel_ms, plain_ms, bound_ms)
      # The kernel reads each input once: its traffic is the bound's bytes.
      log(f'  {name}: {coords.shape[-1]} points, kernel {kernel_ms:.4f} ms, '
          f'wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, '
          f'bound {bound_ms:.4f} ms; its traffic at '
          f'{splat_bytes(coords, feats) / kernel_ms / 1e9:.3f} TB/s '
          f'({power})')
  # One served frame splats the semantic and the RGB cloud once each.
  frame = [sum(timings[(k, 1)][i] for k in ('semantic', 'rgb'))
           for i in range(3)]
  return max_err, frame


def phase_small_vs_cpu(inference, model_config):
  log('== phase 3: small input, card against the CPU path ==')
  cfg = model_config.get_test_config()
  cpu = inference.SE3DSModel(cfg, device='cpu',
                             generator=torch.Generator().manual_seed(1))
  gpu = inference.SE3DSModel(cfg, device='cuda')
  gpu.model.load_state_dict(cpu.model.state_dict())
  rgb, sem, depth = synthetic_pano(cfg.image_height, 3)
  outs = []
  for m in (cpu, gpu):
    m.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32))
    outs.append([m(np.array([[0.1 * i, 0.05, 0.0]], np.float32),
                   add_preds_to_memory=True) for i in (1, 2)])
  for ref, got in zip(*outs):
    moved = ((got.proj_rgb.cpu() != ref.proj_rgb).any(-1)
             | (got.proj_mask.cpu() != ref.proj_mask)[..., 0])
    rgb_err = (got.pred_rgb.cpu().int() - ref.pred_rgb.int()).abs()
    log(f'  guidance pixels moved: {int(moved.sum())} of {moved.numel()}, '
        f'pred_rgb max |d| {int(rgb_err.max())}')
    # CPU and card trig differ by ULPs (points may cross a pixel edge),
    # and TF32 is off, so the generator floats agree to ~1e-6.
    if moved.float().mean() > 0.005 or rgb_err.max() > 1:
      raise AssertionError('card and CPU serving disagree')


def phase_serving(inference, model_config, splat_cuda, power):
  log('== phase 4: full-width serving (1024x512, gen_dims 128, ResNet-101,'
      ' bf16) ==')
  cfg = model_config.SE3DSConfig(
      ckpt_path=None, image_height=H, gen_dims=128, resnet_version='101',
      compute_dtype='bfloat16', memory_frames=8, splat_mode='fast')
  t0 = time.perf_counter()
  model = inference.SE3DSModel(
      cfg, device='cuda',
      generator=torch.Generator(device='cuda').manual_seed(0))
  sync()
  n_params = sum(p.numel() for p in model.model.parameters())
  log(f'  model built: {n_params / 1e9:.3f}B parameters in '
      f'{time.perf_counter() - t0:.2f} s')
  rgb, sem, depth = synthetic_pano(H, 0)
  phase_ms = {}

  splat_cuda.LAUNCHES = splat_cuda.EXACT_LAUNCHES = 0
  t0 = time.perf_counter()
  model.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32),
                      mask_blurred=True)
  sync()
  phase_ms['add_to_memory'] = (time.perf_counter() - t0) * 1e3
  outs = []
  for i in range(3):
    t0 = time.perf_counter()
    outs.append(model(np.array([[0.25 * (i + 1), 0.1, 0.0]], np.float32),
                      add_preds_to_memory=True))
    sync()
    phase_ms[f'step {i + 1}'] = (time.perf_counter() - t0) * 1e3
  t0 = time.perf_counter()
  traj = model.predict_trajectory(
      np.array([[1.0, 0.1 * t, 0.0] for t in range(3)], np.float32))
  sync()
  phase_ms['predict_trajectory T=3'] = (time.perf_counter() - t0) * 1e3
  launches = splat_cuda.LAUNCHES
  frames = 6
  if launches != 2 * frames or splat_cuda.EXACT_LAUNCHES:
    raise AssertionError(f'{launches} splat launches for {frames} frames; '
                         'expected 2 per frame (and no exact one, got '
                         f'{splat_cuda.EXACT_LAUNCHES})')

  for out in outs + [traj]:
    lead = (3,) if out is traj else ()
    want = {'pred_rgb': (lead + (1, H, W, 3), torch.uint8),
            'proj_rgb': (lead + (1, H, W, 3), torch.uint8),
            'pred_semantic': (lead + (1, H, W), torch.uint8),
            'proj_semantic': (lead + (1, H, W), torch.uint8),
            'pred_depth': (lead + (1, H, W), torch.float32),
            'proj_depth': (lead + (1, H, W), torch.float32),
            'proj_mask': (lead + (1, H, W, 1), torch.float32)}
    for key, (shape, dtype) in want.items():
      value = getattr(out, key)
      if tuple(value.shape) != shape or value.dtype != dtype:
        raise AssertionError(f'{key}: {tuple(value.shape)} {value.dtype}, '
                             f'expected {shape} {dtype}')
      if dtype == torch.float32 and not torch.isfinite(value).all():
        raise AssertionError(f'{key} has non-finite values')
    coverage = out.proj_mask.mean(dim=(-3, -2, -1)).flatten()
    if not ((coverage > 0) & (coverage < 1)).all():
      raise AssertionError(f'proj_mask coverage {coverage.tolist()}')
    log(f'  proj_mask coverage {[round(c, 4) for c in coverage.tolist()]}')
  for k, v in phase_ms.items():
    log(f'  {k}: {v:.2f} ms')
  serve_ms = sum(v for k, v in phase_ms.items() if k != 'add_to_memory')
  warm_ms = serve_ms - phase_ms['step 1']
  log(f'  panos/sec over the {frames} served frames: '
      f'{frames / serve_ms * 1e3:.3f}; over the {frames - 1} after the first '
      f'(which includes cuDNN set-up): {(frames - 1) / warm_ms * 1e3:.3f} '
      f'({power})')
  log(f'  splat launches on the main path: {launches} ({frames} frames)')

  # The kernel against its plain version on the main path's own inputs:
  # the memory as the next frame would splat it.
  mem = model._live_memory(model.get_memory_state(copy=False),
                           model._frames_written, model._sem_frames_live())
  from se3ds_torch import constants
  from se3ds_torch.ops import geometry
  pos = torch.tensor([[0.5, 0.0, 0.0, 0.0]], device='cuda')
  for name, xyz, feats, void in (
      ('semantic', mem.coords, mem.feats, constants.INVALID_SEM_VALUE),
      ('rgb', mem.rgb_coords, mem.rgb, constants.INVALID_RGB_VALUE)):
    coords = geometry.equirect_view_coords(xyz - pos[..., None])
    equal_or_raise(f'main-path {name} splat',
                   splat_cuda.splat_fast(coords, feats, H, W, 20.0,
                                         float(void)),
                   splat_cuda.splat_fast_plain(coords, feats, H, W, 20.0,
                                               float(void)))
    log(f'  main-path {name} splat ({coords.shape[-1]} points): kernel == '
        'plain')
  return launches


def exact_bytes(coords, feats, height=H, width=W):
  """Bytes the exact splat must move: x, y, z and the features of each
  point read once, the depth and the C feature planes written once."""
  batch, _, m = coords.shape
  channels = feats.shape[-1]
  return batch * m * (12 + 4 * channels) + batch * height * width * (
      4 + 4 * channels)


def exact_two_pass_bytes(coords, feats):
  """Bytes the two-pass kernel itself moves: pass 1 reads x, y, z and the
  features of each point, pass 2 reads them again with the point's
  z-buffer entry; both buffers are written once."""
  batch, _, m = coords.shape
  channels = feats.shape[-1]
  return batch * m * (28 + 8 * channels) + batch * H * W * (4 + 4 * channels)


def exact_timings(splat_cuda, coords, feats, void, out_void, reps=20):
  """(kernel ms, wrapper ms, plain ms, bound ms) of the exact splat at
  full width. The kernel runs both passes into buffers filled once (min
  and max are idempotent); the wrapper also fills them and decodes."""
  coords_k, feats_k = splat_cuda.check_inputs(coords, feats, H, W,
                                              max_channels=None)
  batch, channels = coords.shape[0], feats.shape[-1]
  zbuf = torch.full((batch, H * W), 20.0, device=coords.device)
  fbuf = torch.full((batch, H * W, channels), splat_cuda.order_key(out_void),
                    dtype=torch.int32, device=coords.device)
  kernel_ms = time_ms(lambda: splat_cuda.launch_splat_exact(
      coords_k, feats_k, H, W, void, zbuf, fbuf), reps=reps)
  wrapper_ms = time_ms(lambda: splat_cuda.splat_exact(
      coords, feats, H, W, 20.0, void, out_void), reps=reps)
  plain_ms = time_ms(lambda: splat_cuda.splat_exact_plain(
      coords, feats, H, W, 20.0, void, out_void), reps=max(3, reps // 5))
  bound_ms = exact_bytes(coords, feats) / HBM_BYTES_PER_S * 1e3
  return kernel_ms, wrapper_ms, plain_ms, bound_ms


def compare_exact(splat_cuda, name, coords, feats, void, out_void,
                  height=H, width=W, depth_scale=20.0):
  """Kernel and plain version on the same card tensors; returns max |d|
  and raises unless both outputs are torch.equal."""
  plain = splat_cuda.splat_exact_plain(coords, feats, height, width,
                                       depth_scale, void, out_void)
  err = equal_or_raise(name, splat_cuda.splat_exact(
      coords, feats, height, width, depth_scale, void, out_void), plain)
  hit = int((plain[1] != out_void).any(-1).sum())
  log(f'  {name}: equal ({coords.shape[0]}x{coords.shape[-1]} points, '
      f'{hit} pixels hit)')
  return err


def phase_exact_parity(splat_cuda, power):
  log('== phase 5: exact CUDA splat against its plain version ==')
  device = torch.device('cuda')
  max_err = 0.0
  edges = edge_clouds(device)
  for name, (coords, feats) in edges.items():
    for out_void in (0.0, -1.0):
      max_err = max(max_err, compare_exact(
          splat_cuda, f'{name}, output void {out_void}', coords, feats,
          -1.0, out_void, 64, 128))
  base, feats = edges['void features']
  rs = np.random.RandomState(8)
  negative = torch.from_numpy(
      rs.randint(-40, 40, tuple(feats.shape)) / 4.0).float().to(device)
  max_err = max(max_err, compare_exact(
      splat_cuda, 'negative non-void features', base, negative, -1.0, -1.0,
      32, 64))
  # Depths around depth_scale: the minimum clips to 20, the window tests
  # the raw depth against 20.1.
  depth = torch.from_numpy(rs.uniform(19.8, 20.6, base.shape[-1])).float()
  beyond = base * (depth.to(device) / base[:, 2])
  beyond[:, 3] = 1.0
  max_err = max(max_err, compare_exact(
      splat_cuda, 'beyond depth_scale', beyond, feats, -1.0, -1.0, 32, 64))

  # Collision-heavy full-width clouds: up to 4 frames per batch element
  # (the RGB cloud uncompacted, as the rollout memory holds it).
  clouds = view_clouds(8, frames=4, seed=11, device=device, compact=False)
  for coords, feats, void in clouds:
    for batch in (1, 8):
      for frames in (1, 2, 4):
        extent = frames * H * W
        max_err = max(max_err, compare_exact(
            splat_cuda, f'C={feats.shape[-1]} batch {batch} {frames} '
            'frames', coords[:batch, :, :extent], feats[:batch, :extent],
            void, -1.0))
  coords, feats, void = clouds[1]
  for frames in (1, 2, 4):
    extent = frames * H * W
    kernel_ms, wrapper_ms, plain_ms, bound_ms = exact_timings(
        splat_cuda, coords[:, :, :extent], feats[:, :extent], void, -1.0)
    traffic = exact_two_pass_bytes(coords[:, :, :extent], feats[:, :extent])
    log(f'  C=3 batch 8, {extent} points each: kernel {kernel_ms:.4f} ms, '
        f'wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{bound_ms:.4f} ms; its own two-pass traffic {traffic / 1e6:.1f} MB '
        f'at {traffic / kernel_ms / 1e9:.3f} TB/s ({power})')
  return max_err


def synthetic_video(batch, frames, height, seed):
  """A video batch as the data pipeline yields it: RGB in [0, 1], smooth
  depth in (0.05, 0.9), a short walk of poses (x, y, z, 0) in metres."""
  rs = np.random.RandomState(seed)
  width = 2 * height
  rows = np.linspace(0, np.pi, height, dtype=np.float32)[:, None]
  cols = np.linspace(0, 2 * np.pi, width, dtype=np.float32)[None, :]
  phase = rs.uniform(0, 2 * np.pi, (batch, frames, 1, 1)).astype(np.float32)
  depth = (0.15 + 0.1 * np.abs(np.cos(rows)) + 0.05 * np.sin(3 * cols + phase)
           ).astype(np.float32)
  depth = np.clip(depth, 0.05, 0.9)[..., None]
  texture = np.sin(5 * cols + 3 * rows + phase)[..., None]
  image = np.clip(0.5 + 0.4 * texture + rs.uniform(
      -0.05, 0.05, (batch, frames, height, width, 3)), 0, 1).astype(
          np.float32)
  position = np.zeros((batch, frames, 4), np.float32)
  position[..., :2] = np.cumsum(rs.uniform(0.05, 0.2, (batch, frames, 2)),
                                axis=1)
  position[:, 0] = 0.0
  return {'image': image, 'original_image': image, 'depth': depth,
          'position': position}


def eval_generator(inference, config, device, seed):
  """The generator SE3DSModel builds for `config` (seeded random weights,
  conv kernels in the compute dtype) on `device`."""
  model = inference.SE3DSModel(
      dataclasses.replace(config, memory_frames=1), device=device,
      generator=torch.Generator(device=device).manual_seed(seed))
  return model.model


def phase_eval(inference, model_config, splat_cuda, power):
  log('== phase 6: full-width FID eval (1024x512, gen_dims 128, ResNet-101,'
      f' bf16, T={EVAL_FRAMES}, batch {EVAL_BATCH}) ==')
  from se3ds_torch import constants
  from se3ds_torch.eval import fid as fid_lib
  from se3ds_torch.eval import inception as inception_lib
  from se3ds_torch.eval import metrics
  cfg = model_config.SE3DSConfig(ckpt_path=None, image_height=H,
                                 gen_dims=128, resnet_version='101',
                                 compute_dtype='bfloat16')
  generator = eval_generator(inference, cfg, 'cuda', seed=0)
  t0 = time.perf_counter()
  videos = [synthetic_video(EVAL_BATCH, EVAL_FRAMES, H, seed)
            for seed in (1, 2)]
  log(f'  synthetic video batches made in {time.perf_counter() - t0:.2f} s')
  depth_scale = constants.DEPTH_SCALE

  # Warm-up rollout (cuDNN picks its algorithms), which also records the
  # splat inputs of each frame; then the timed one, through the real
  # wrapper with nothing recorded.
  recorded = []
  kernel_wrapper = splat_cuda.splat_exact

  def recording(coords, feats, *args):
    recorded.append((coords.clone(), feats.clone()))
    return kernel_wrapper(coords, feats, *args)

  splat_cuda.splat_exact = recording
  try:
    metrics.rollout_generated(generator, videos[0], EVAL_FRAMES, depth_scale,
                              device='cuda')
  finally:
    splat_cuda.splat_exact = kernel_wrapper
  sync()
  splat_cuda.LAUNCHES = splat_cuda.EXACT_LAUNCHES = 0
  t0 = time.perf_counter()
  generated, rmse, aux = metrics.rollout_generated(
      generator, videos[0], EVAL_FRAMES, depth_scale, device='cuda')
  sync()
  rollout_s = time.perf_counter() - t0
  rollout_launches = splat_cuda.EXACT_LAUNCHES
  if rollout_launches != 2 * EVAL_FRAMES or splat_cuda.LAUNCHES:
    raise AssertionError(f'{rollout_launches} exact launches for '
                         f'{EVAL_FRAMES} frames (expected 2 per frame), '
                         f'{splat_cuda.LAUNCHES} fast ones (expected 0)')
  for i in range(EVAL_FRAMES):
    frame, mask = generated[i], aux['proj_mask'][i]
    if (tuple(frame.shape) != (EVAL_BATCH, H, W, 3)
        or not torch.isfinite(frame).all() or not torch.isfinite(rmse[i]).all()
        or not torch.isfinite(aux['pred_depth'][i]).all()):
      raise AssertionError(f'frame {i}: {tuple(frame.shape)} or non-finite')
    coverage = mask.mean(dim=(1, 2, 3))
    if i and not ((coverage > 0) & (coverage < 1)).all():
      raise AssertionError(f'frame {i} proj_mask coverage {coverage}')
    log(f'  frame {i}: proj_mask coverage '
        f'{[round(c, 4) for c in coverage.tolist()]}, RMSE '
        f'{[round(r, 5) for r in rmse[i].tolist()]}')
  log(f'  rollout: {rollout_s * 1e3 / EVAL_FRAMES:.2f} ms per rollout frame '
      f'of batch {EVAL_BATCH}, {EVAL_BATCH * EVAL_FRAMES / rollout_s:.3f} '
      f'eval frames/sec ({power})')

  # The eval entry point: real pools at construction, then the FID.
  rng = torch.Generator(device='cuda').manual_seed(0)
  inception = inception_lib.init_inception(
      torch.Generator(device='cuda').manual_seed(42))
  splat_cuda.LAUNCHES = splat_cuda.EXACT_LAUNCHES = 0
  t0 = time.perf_counter()
  metric = metrics.EvalMetric(
      lambda: iter(videos), eval_num=EVAL_BATCH, batch_size=EVAL_BATCH,
      avg_num=1, eval_seq_len=EVAL_FRAMES, depth_scale=depth_scale,
      inception_model=inception, rng=rng, device='cuda')
  fid, fid_std, eval_rmse, inception_score = metric.calculate_fid_score(
      generator)
  eval_s = time.perf_counter() - t0
  eval_launches = splat_cuda.EXACT_LAUNCHES
  # eval_num // batch_size + 1 = 2 rollouts.
  if eval_launches != 2 * 2 * EVAL_FRAMES or splat_cuda.LAUNCHES:
    raise AssertionError(f'EvalMetric: {eval_launches} exact launches, '
                         f'{splat_cuda.LAUNCHES} fast ones')
  for name, values in (('FID', fid), ('RMSE', eval_rmse),
                       ('IS', inception_score)):
    if (set(values) != set(range(1, EVAL_FRAMES))
        or not all(np.isfinite(v) for v in values.values())):
      raise AssertionError(f'{name}: {values}')
  log(f'  EvalMetric.calculate_fid_score: FID {fid}, RMSE {eval_rmse}, IS '
      f'{inception_score} in {eval_s:.2f} s (2 real-pool batches, 2 '
      'rollouts, 3 FIDs)')

  crop = metrics._augment_crop_for_inception(generated[1], rng)
  inception_ms = time_ms(lambda: inception_lib.get_inception(
      crop, inception), reps=10)
  log(f'  Inception: {inception_ms:.3f} ms per batch of {EVAL_BATCH} '
      f'({tuple(crop.shape[1:3])} -> 299x299) ({power})')
  t0 = time.perf_counter()
  fid_lib.calculate_fid(metric._pool[1], metric._pool[2])
  log(f'  host FID (2048-d, {EVAL_BATCH} samples, scipy sqrtm): '
      f'{time.perf_counter() - t0:.2f} s')

  # The kernel on the rollout's own splat inputs, frame by frame.
  max_err, frame_times = 0.0, []
  void = float(constants.INVALID_RGB_VALUE)
  for i, (coords, feats) in enumerate(recorded):
    max_err = max(max_err, compare_exact(
        splat_cuda, f'rollout frame {i}', coords, feats, void, 0.0))
    frame_times.append(exact_timings(splat_cuda, coords, feats, void, 0.0))
  per_frame = [statistics.mean(t[i] for t in frame_times) for i in range(4)]
  log(f'  exact splat per rollout frame (mean of {len(recorded)}): kernel '
      f'{per_frame[0]:.4f} ms, wrapper {per_frame[1]:.4f} ms, plain '
      f'{per_frame[2]:.4f} ms, bound {per_frame[3]:.4f} ms ({power})')
  return rollout_launches, max_err, per_frame


def phase_eval_small_vs_cpu(inference, model_config):
  log('== phase 6b: small rollout, card against the CPU path ==')
  from se3ds_torch.eval import metrics
  cfg = model_config.get_test_config()
  cpu = eval_generator(inference, cfg, 'cpu', seed=1)
  gpu = eval_generator(inference, cfg, 'cuda', seed=1)
  gpu.load_state_dict(cpu.state_dict())
  video = synthetic_video(2, 3, cfg.image_height, seed=3)
  outs = [metrics.rollout_generated(g, video, 3, cfg.depth_scale,
                                    device=device)
          for g, device in ((cpu, 'cpu'), (gpu, 'cuda'))]
  (gen_c, _, aux_c), (gen_g, _, aux_g) = outs
  for i in range(3):
    moved = ((aux_g['projected'][i].cpu() != aux_c['projected'][i]).any(-1)
             | (aux_g['proj_mask'][i].cpu() != aux_c['proj_mask'][i])[..., 0])
    same = ~moved[..., None]
    err = float(((gen_g[i].cpu() - gen_c[i]).abs() * same).max())
    log(f'  frame {i}: guidance pixels moved {int(moved.sum())} of '
        f'{moved.numel()}, generated max |d| {err:.3g} elsewhere')
    # CPU and card trig differ by ULPs (a point may cross a pixel edge)
    # and TF32 is off, so the generator floats agree to ~1e-6.
    if moved.float().mean() > 0.005 or err > 1e-4:
      raise AssertionError('card and CPU rollouts disagree')


def main():
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this script runs on the card.',
          file=sys.stderr)
    return 2
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from se3ds_torch.models import inference
  from se3ds_torch.models import model_config
  from se3ds_torch.ops import cuda_build
  from se3ds_torch.ops import splat_cuda

  log('== phase 1: device and build ==')
  power = card_name_and_power()
  log(power)
  log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
      f'{torch.cuda.get_device_name(0)}')
  t0 = time.perf_counter()
  paths = cuda_build.build()
  log(f'built {sorted(paths)} in {time.perf_counter() - t0:.2f} s')
  for name, path in paths.items():
    info = path.with_name(path.name + '.log')
    if info.exists():
      log(f'  {name}: {info.read_text().strip()}')
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False

  max_err, (ms, plain_ms, bound_ms) = phase_kernel_parity(splat_cuda, power)
  phase_small_vs_cpu(inference, model_config)
  launches = phase_serving(inference, model_config, splat_cuda, power)
  exact_err = phase_exact_parity(splat_cuda, power)
  exact_launches, rollout_err, exact_times = phase_eval(
      inference, model_config, splat_cuda, power)
  phase_eval_small_vs_cpu(inference, model_config)
  log(f'splat per served frame (semantic + RGB, 1024x512): kernel {ms:.4f} '
      f'ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms')
  log(f'exact splat per rollout frame (batch {EVAL_BATCH}, C=3, 1024x512): '
      f'kernel {exact_times[0]:.4f} ms, plain {exact_times[2]:.4f} ms, '
      f'bound {exact_times[3]:.4f} ms')
  log(f'chip_smoke took {time.perf_counter() - START:.1f} s')
  log(power)

  log(json.dumps({'kernels': [{
      'name': 'splat_fast', 'route': 'cuda',
      'source': 'se3ds_torch/csrc/splat.cu', 'replaces': SPLAT_REPLACES,
      'launches': launches, 'max_abs_err': max_err, 'ms': ms,
      'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': 'bytes',
      'library_ms': None}, {
          'name': 'splat_exact', 'route': 'cuda',
          'source': 'se3ds_torch/csrc/splat_exact.cu',
          'replaces': EXACT_REPLACES, 'launches': exact_launches,
          'max_abs_err': max(exact_err, rollout_err), 'ms': exact_times[0],
          'plain_ms': exact_times[2], 'bound_ms': exact_times[3],
          'bound_by': 'bytes', 'library_ms': None}]}))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
