"""Drives the PyTorch/CUDA port of SE3DS (serving and its API, every
splat mode and the mesh, FID eval and GAN training, remat and the
data-parallel paths, a released-format checkpoint's import) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:
  1. Device and build: the card's name and power limit, then every CUDA
     source of se3ds_torch built with nvcc (one process per source), with
     each kernel's registers and shared memory from ptxas.
  2. The 'fast' splat against its plain version: the main path's form
     (world points and a camera offset, the view coordinates computed in
     the kernel, then the resolve) against the plain path (translate,
     `equirect_view_coords`, plain splat), and the kernel's view-coordinate
     form against `splat_fast_plain`, on edge cases and at full width
     (512x1024 pixels, ~1.05M points with 1 channel and no depth, ~0.79M
     points with 3 channels, batch 1 and 2). Results must be torch.equal.
     Times the point pass, the resolve, the whole stage and the plain
     version.
  3. Small input against the CPU path: the same weights and pano through
     SE3DSModel on the card and on the CPU (plain versions); then the splat
     stage alone on one memory, card against CPU: proj_depth bit-equal on
     the pixels whose points did not move (nor take a radius that the
     CPU's sqrt rounds off).
  4. Full-width serving: SE3DSModel at 1024x512, gen_dims=128, ResNet-101,
     bf16, from a seeded generator; add_to_memory, three
     add_preds_to_memory=True calls and one predict_trajectory of T=3.
     Checks shapes, dtypes, finite values, proj_mask coverage in (0, 1)
     and exactly 2 'fast' point-pass launches per served frame (and no
     exact one), then holds the stage against its plain version on the
     main path's own memory and times it (point passes, resolves, whole
     stage, plain). The epilogue kernel's launches on this run, every
     convolution output read by it (`generator.fused_convs` equal to
     `generator.convs`); the wrap kernel's launches, one for every
     circular pad (`wrap.launches` equal to `generator.wrap_pads`).
  4b. The conv epilogue kernel (csrc/epilogue.cu) and the circular wrap
     kernel (csrc/wrap.cu) on the served generator's own calls, phase 4's
     config run eagerly: one served step (batch 1) and one predict_poses
     call (batch 8), every call of `layers.epilogue` (each a kernel
     launch) held torch.equal to `layers.epilogue_plain` on the same
     inputs, and every circular call of `layers._padded` (each a kernel
     launch) torch.equal to its plain body (which runs where autograd
     records); then each kernel's device time per call, the whole call's
     with the kernel's plain body in its place, and the kernel's bytes
     over the card's memory rate.
  5. The exact splat against its plain version: both forms, torch.equal
     on depth and features, on edge cases (with output void 0 and -1,
     negative features, points beyond depth_scale) and on collision-heavy
     full-width clouds (~0.5M, 1.05M and 2.1M points, C=3 and C=1, batch 1
     and 8, batch slices of a larger memory). Times the cooperative
     launch, the resolve, the whole stage, the plain version, and the
     'fast' point pass on the same points as the cost of one read.
  6. Full-width FID-eval rollout: ResNetGenerator(gen_dims=128,
     ResNet-101) in bf16 from a seeded generator, 1024x512, batch 8, T=4,
     the exact splat: rollout_generated (shapes, finite values, proj_mask
     coverage, exactly 1 exact launch per frame and no 'fast' one),
     Inception's time per batch; the stage against its plain version on
     the rollout's own inputs, timed; the test config's rollout on the
     card against the CPU. (The FID runs in phase 8.)
  7. Full-width lowres training: `Trainer.train` at the lowres recipe's
     values (256x128, G gen_dims=128 ResNet-101, D dis_dims=128 n_dis=2
     n_layers=6, float32 with cuDNN's TF32 convolutions), 16 examples a
     chunk, random weights from seed 0 and synthetic batches, 4 steps of
     one cluster each: every metric finite, G and D parameters moved, the
     EMA equal to G after the assign step and not after the decay steps,
     ms per step, FLOPs per step (`Trainer.step_flops`, counted on the
     meta device) and TFLOP/s against the dense TF32 peak, peak device
     memory, the final checkpoint (written, sized, deleted), then the
     'train' image grid.
  7b. The tests' tiny trainer: one train step on the card (TF32 off)
     against the CPU and against the CPU in float64, within stated
     tolerances, and a checkpoint round trip on the card, bit-equal.
  8. The system's own entry point on the lowres recipe: fixture TFRecords
     written by `se3ds_torch.data.synthetic` in worker processes (image
     pairs at the recipe's stored 1024x2048, videos at 128x256), host ms
     per example to decode and transform on each record path, then
     `python -m se3ds_torch.main --mode TRAIN` with configs/lowres/lowres.gin
     at full width (4 steps of 2 chunks of 16, one ~17 GiB save) in a
     subprocess, and `se3ds_torch.main.main(['--mode', 'TEST', ...])` in
     this process: it finds the step-4 checkpoint by polling, evaluates it
     (image grid, PNG dumps, FID/RMSE/IS through two calculate_fid_score
     calls) with exactly 24 exact-splat launches; finite scores at @1..@3
     in scores_val_seen.csv, every PNG there, the parameters moved, and one
     display-batch rollout frame's guidance equal to the plain version.
  9. The serving API at full width, on phase 4's config; every splat
     stage on these paths is held against its plain version (torch.equal)
     as it runs, inside the captured graphs too (a key's second call
     captures the check with the stage; a replay checks on the device):
     (a) ring memory (memory_frames 8): add_to_memory, 11
     feedback steps (the write wraps at the 8th) and a predict_trajectory
     of 3, ms per step before and after the wrap, the memory buffers
     never reallocated; (b) predict_poses at K = 8 on a stride-0 memory
     against 8 single calls (guidance equal, outputs within a bf16 band),
     ms per pose and per call, peak device memory; (c)
     sample_perturbed_views, 16 views in chunks of 8, ms per view; (d)
     the RE10K config: a 512x512 perspective source warped on the card
     (against the CPU), add_to_memory(mask_blurred=False), 3 steps and a
     perspective view; (e) write_memory_as_pointcloud after one frame,
     seconds and bytes; (f) SE3DSModel(ckpt_path=...) on phase 8's
     step-4 checkpoint (image 128, gen_dims 128, ResNet-101), the restore
     seconds, its weights and outputs torch.equal to a model built from
     folding.serving_state_dict of the same bundle. Phase 8's directory
     is deleted after phase 9.
  10. Full-width highres training (configs/highres/highres.gin: 1024x512,
     G and D as phase 7), as phase 7 measures it: (a) without remat at
     HIGHRES_CHUNK a chunk, the largest that fits; (b) with remat at the
     recipe's share of one card, 8 a chunk. Then on the tests' tiny
     trainer: (d) two steps with remat against two storing activations,
     cuDNN deterministic, torch.equal throughout, every `u` and BatchNorm
     statistic advanced; (e) a step through a world-1 NCCL process group
     (`file://` rendezvous: the synced BatchNorm, the gradient all_reduce,
     the checkpoint consolidation) against the plain step, float64,
     within stated tolerances.
  11. Modes and mesh, on phase 4's config: (a) 'fast_exact', 'sorted',
     'sorted_packed' and 'dual_sorted' through SE3DSModel, 3 feedback
     steps each: every splat stage torch.equal to the same function on
     the CPU on the card's view coordinates, and the byte-exact modes to
     the exact kernel's guidance; the stage's device ms per served frame
     for every mode beside 'fast' and 'scatter'; (b) a world-1 NCCL group
     and `create_mesh(1, 1)`: SE3DSModel(mesh=...) with 'fast',
     'fast_exact', 'scatter' and 'pallas' (run as 'fast'), a 3-step
     predict_trajectory and predict_poses at K = 8, every output
     torch.equal to the meshless model (cuDNN deterministic), ms per step
     with and without the mesh; the split exact passes against the
     cooperative launch (words torch.equal) with their device ms; (c)
     'fast' with 5 channels against the exact kernel; (d) Trainer.test
     through `torchrun --standalone --nproc_per_node 1 -m se3ds_torch.main
     --mode TEST` on phase 8's checkpoint (run between phases 9 and 10,
     while it exists), its scores against phase 8's TEST scores.
  12. A release-format checkpoint at full width: (a) phase 4's generator
     (gen_dims 128, ResNet-101) in its trainable form with seeded weights,
     written by `tf_bundle.write_bundle` as an `ema_generator` bundle
     under the released checkpoints' TF key names and Keras layouts
     (~4.46 GB, 1,765 tensors and save_counter) with its `checkpoint`
     state file; (b) `python -m se3ds_torch.convert_tf_checkpoint` on the
     directory in a subprocess (its seconds, GB/s and peak RSS); (c) the
     converted file and the source's own `save_ema_generator` file served
     through SE3DSModel(ckpt_path=...) in bf16: weights torch.equal, and
     add_to_memory plus 2 feedback steps torch.equal with cuDNN
     deterministic; (d) `utils/math_utils`' IoU, accuracy, KL and
     nearest-neighbour inpainting on the card against the CPU; (e) a line
     saying whether h5py is here (the `.h5` loader is not run). The
     bundle and the files are deleted after the phase.
  13. The serving calls as captured CUDA graphs, on phase 4's config: a
     model with cuda_graphs=False and one with the default (captured),
     the same seeded weights and inputs, 5 passes in turns of
     reset_memory, add_to_memory, 3 feedback steps, 2 read-only calls,
     predict_trajectory T=3 and predict_poses K=8 (the first pass warms
     each key up, the second captures, every later call replays): every
     OutputData field torch.equal graph vs eager, and eager against its
     own first pass; the launch counts; ms per warm step, per read-only
     call, per trajectory frame and per pose, host CPU ms per call, each
     key's capture seconds, the graphs and their pool's GiB; then
     'pallas_exact' (the exact kernel's cooperative launch captured), 3
     passes, torch.equal. A mode whose eager passes differ among
     themselves (cuDNN's default algorithms summing in any order) is run
     again with cuDNN's deterministic algorithms, where graph and eager
     must be torch.equal.
Phases 4, 9 and 11 serve through captured graphs by default (phase 11b's
mesh model eagerly, as decided at its construction); a key's first call
runs eagerly, so phases 4, 11 and 12, whose keys are each called once,
replay few graphs. The line before the last is a JSON object with one
entry per kernel; the last line is {"ok": true, "device": {...}}.
"""

import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from se3ds_torch import tracing

H, W = 512, 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
DEPTH_SCALE = 20.0
SPLAT_REPLACES = 'se3ds_tpu/ops/splat_pallas.py:87'
EXACT_REPLACES = 'se3ds_tpu/ops/splat_pallas.py:204'
EVAL_BATCH, EVAL_FRAMES = 8, 4  # one card's share of highres test_batch_size
REPO = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(REPO, 'build')
LOWRES_GIN = os.path.join(REPO, 'configs', 'lowres', 'lowres.gin')


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


# The point-pass launch counters of `se3ds_torch.tracing`.
FAST, EXACT = 'splat.fast_launches', 'splat.exact_launches'


def set_launches(fast=0, exact=0):
  for name, value in ((FAST, fast), (EXACT, exact)):
    tracing.counter(name, value - tracing.count(name))


# The epilogue kernel's launches and the convolutions it reads, of all.
EPILOGUE_COUNTERS = ('epilogue.launches', 'generator.fused_convs',
                     'generator.convs')
EPILOGUE_KERNEL = 'epilogue_kernel'  # csrc/epilogue.cu, by profiler name
# The wrap kernel's launches and the circular pads it makes, of all.
WRAP_COUNTERS = ('wrap.launches', 'generator.wrap_pads')
WRAP_KERNEL = 'wrap_kernel'  # csrc/wrap.cu, by profiler name


def zero_counters(names):
  for name in names:
    tracing.counter(name, -tracing.count(name))


def time_ms(fn, reps, warmup=2):
  """Median over `reps` runs of the device time between CUDA events
  recorded around one call of fn, in ms (host gaps included)."""
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


def device_ms(fn, reps=20, attempts=3):
  """Device time per call of fn in ms: the kernels and memsets it runs,
  summed by the profiler, without the host's gaps between them.

  The profiler now and then returns a session with no device events
  (CUPTI drops them); after `attempts` such sessions the time is taken
  with CUDA events around `reps` back-to-back calls instead, which
  counts the host's launch gaps where they exceed the device's work,
  and the log says so."""
  fn()
  sync()
  for _ in range(attempts):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      sync()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us:
      return total_us / reps / 1e3
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  ms = start.elapsed_time(end) / reps
  log(f'  (the profiler recorded no device time in {attempts} sessions; '
      f'{ms:.4f} ms per call from CUDA events around {reps} back-to-back '
      'calls, host gaps included)')
  return ms


def profiled_ms(fn, kernel, reps=5, attempts=3):
  """(device ms per call of fn, the part of it in kernels whose name
  holds `kernel`), summed by the profiler. Raises where the profiler
  records no device time in `attempts` sessions: the kernel's part has
  no other source."""
  fn()
  sync()
  for _ in range(attempts):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      sync()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    if total_us:
      part_us = sum(e.self_device_time_total for e in events
                    if kernel in e.key)
      return total_us / reps / 1e3, part_us / reps / 1e3
  raise AssertionError(f'the profiler recorded no device time in '
                       f'{attempts} sessions')


def equal_or_raise(name, kernel_outs, plain_outs):
  """Max |d| between a kernel's outputs and its plain version's; raises
  unless every pair is torch.equal. A None kernel output (a depth not
  asked for) is skipped."""
  sync()
  pairs = [(k, p) for k, p in zip(kernel_outs, plain_outs) if k is not None]
  err = max((float((k - p).abs().max()) for k, p in pairs if k.numel()),
            default=0.0)
  if not all(torch.equal(k, p) for k, p in pairs):
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


def world_clouds(batch, frames, seed, device, compact=True):
  """Full-width world-point memories made by the port's own geometry:
  `frames` panos per batch element unprojected at shifted poses, and the
  (batch, 4) camera offset they are seen from. With `compact` the RGB
  cloud keeps only the rows mask_pano leaves. Returns ([(xyz, feats,
  void) for the semantic and the RGB cloud], offset)."""
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
  offset = torch.tensor([[0.2, -0.1, 0.05, 0.0]], device=device).expand(
      batch, 4).contiguous()
  return [(torch.cat(sem_xyz), torch.cat(sem_f),
           float(constants.INVALID_SEM_VALUE)),
          (torch.cat(rgb_xyz), torch.cat(rgb_f),
           float(constants.INVALID_RGB_VALUE))], offset


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


def stage_bytes(xyz, feats, need_depth, height=H, width=W):
  """Bytes a splat stage must move: x, y, z and the features of each
  point read once, the returned depth (if asked for) and feature planes
  written once."""
  batch, _, m = xyz.shape
  channels = feats.shape[-1]
  return batch * m * (12 + 4 * channels) + batch * height * width * (
      4 * need_depth + 4 * channels)


def fast_stage(geometry, xyz, feats, offset, void, need_depth,
               height=H, width=W):
  """The 'fast' stage, world memory to images, and its plain version."""
  args = (feats, xyz, offset, height, width, void, DEPTH_SCALE, 'fast')
  return (lambda: geometry.project_memory_equirect(*args,
                                                   need_depth=need_depth),
          lambda: geometry.project_memory_equirect_plain(*args))


def fast_timings(splat_cuda, geometry, xyz, feats, offset, void, need_depth):
  """Device ms of the point pass (and of the same pass over precomputed
  view coordinates, which leaves out the prelude's arithmetic) and of the
  resolve, the whole stage (events, and device ms), the plain version
  (events) and the bound, at full width."""
  kernel, plain = fast_stage(geometry, xyz, feats, offset, void,
                             need_depth)
  words = lambda: splat_cuda.fast_words(xyz, feats, H, W, DEPTH_SCALE, void,
                                        offset=offset, need_depth=need_depth)
  done = words()
  view = geometry.equirect_view_coords(xyz - offset[..., None])
  return {
      'point': device_ms(words),
      'view_point': device_ms(lambda: splat_cuda.fast_words(
          view, feats, H, W, DEPTH_SCALE, void, need_depth=need_depth)),
      'resolve': device_ms(lambda: splat_cuda.fast_resolve(
          done, feats.shape[-1], DEPTH_SCALE, 0.0)),
      'stage': time_ms(kernel, reps=50),
      'stage_device': device_ms(kernel),
      'plain': time_ms(plain, reps=10),
      'bound': stage_bytes(xyz, feats, need_depth) / HBM_BYTES_PER_S * 1e3}


def log_timings(name, t, power):
  log(f'  {name}: point pass {t["point"]:.4f} ms ({t["view_point"]:.4f} ms '
      f'on precomputed view coordinates), resolve {t["resolve"]:.4f} ms '
      f'(device), whole stage {t["stage"]:.4f} ms '
      f'(events; {t["stage_device"]:.4f} ms device), plain {t["plain"]:.4f} '
      f'ms, bound {t["bound"]:.4f} ms ({power})')


def phase_kernel_parity(splat_cuda, geometry, power):
  log('== phase 2: the fast CUDA splat against its plain version ==')
  device = torch.device('cuda')
  max_err = 0.0
  offset = torch.tensor([[0.3, -0.2, 0.1, 0.0]], device=device)

  def compare_buffers(name, coords, feats, void, height=H, width=W):
    nonlocal max_err
    plain = splat_cuda.splat_fast_plain(coords, feats, height, width,
                                        DEPTH_SCALE, void)
    max_err = max(max_err, equal_or_raise(name, splat_cuda.splat_fast(
        coords, feats, height, width, DEPTH_SCALE, void), plain))
    log(f'  {name}, view coordinates: equal ({coords.shape[-1]} points, '
        f'{int((plain[1] != 0).sum())} pixels hit)')

  def compare_stage(name, xyz, feats, offset, void, need_depth, height=H,
                    width=W):
    nonlocal max_err
    kernel, plain = fast_stage(geometry, xyz, feats, offset,
                               void, need_depth, height, width)
    want = plain()
    max_err = max(max_err, equal_or_raise(name, kernel(), want))
    log(f'  {name}, world points (depth {need_depth}): equal '
        f'({xyz.shape[-1]} points)')

  for name, (coords, feats) in edge_clouds(device).items():
    compare_buffers(name, coords, feats, -1.0, 64, 128)
    for need_depth in (True, False):
      compare_stage(name, coords, feats, offset, -1.0, need_depth, 64, 128)

  frame = {}
  for batch in (1, 2):
    clouds, target = world_clouds(batch, frames=2, seed=batch, device=device)
    for (xyz, feats, void), kind, need_depth in zip(
        clouds, ('semantic', 'rgb'), (False, True)):
      name = f'{kind} C={feats.shape[-1]} batch {batch}'
      compare_stage(name, xyz, feats, target, void, need_depth)
      compare_buffers(name, geometry.equirect_view_coords(
          xyz - target[..., None]), feats, void)
      if batch == 1:
        t = fast_timings(splat_cuda, geometry, xyz, feats, target, void,
                         need_depth)
        log_timings(f'{name}, {xyz.shape[-1]} points', t, power)
        frame = {k: frame.get(k, 0.0) + v for k, v in t.items()}
  log_timings('per served frame (semantic + RGB, batch 1)', frame, power)
  return max_err


def pixels_apart(geometry, splat, xyz, feats, position, height, width):
  """Two (B, H, W) bool masks for the same RGB points on the card and on
  the CPU: the pixels a point enters or leaves between the two devices'
  view coordinates (their trigonometry differs by ULPs), and the pixels
  of the points whose radius the CPU's torch.sqrt does not round
  correctly (numpy's float32 sqrt, as the card's, does)."""
  offset = torch.cat([position, torch.zeros((1, 1))], 1)
  flats = [splat.pixel_coords(geometry.equirect_view_coords(
      x - offset.to(x.device)[..., None]), f, height, width, -1.0)[0].cpu()
           for x, f in ((xyz, feats), (xyz.cpu(), feats.cpu()))]
  rel = xyz.cpu() - offset[..., None]
  sq = rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1] + rel[:, 2] * rel[:, 2]
  sqrt_off = torch.sqrt(sq) != torch.from_numpy(np.sqrt(sq.numpy()))
  masks = []
  for points, sources in ((flats[0] != flats[1], flats), (sqrt_off,
                                                          flats[1:])):
    mask = torch.zeros((xyz.shape[0], height * width + 1), dtype=torch.bool)
    for flat in sources:
      mask.scatter_(1, torch.where(points, flat, height * width), True)
    masks.append(mask[:, :-1].reshape(-1, height, width))
  return masks


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
    depth_off = int((got.proj_depth.cpu() != ref.proj_depth)[~moved].sum())
    log(f'  served frame: guidance pixels moved {int(moved.sum())} of '
        f'{moved.numel()}, proj_depth off the CPU\'s bits on {depth_off} '
        f'unmoved pixels (the memories differ: unprojection trig), pred_rgb '
        f'max |d| {int(rgb_err.max())}')
    # CPU and card trig differ by ULPs (points may cross a pixel edge),
    # and TF32 is off, so the generator floats agree to ~1e-6.
    if moved.float().mean() > 0.005 or rgb_err.max() > 1:
      raise AssertionError('card and CPU serving disagree')

  # The splat stage alone on one memory (the card's, copied to the CPU):
  # the depth is a square root and a divide, so it is bit-equal on every
  # pixel that no point entered or left, but for the CPU's torch.sqrt,
  # which is not always correctly rounded.
  from se3ds_torch.ops import geometry
  from se3ds_torch.ops import splat
  from se3ds_torch.ops import splat_cuda
  live = gpu._live_memory(gpu.get_memory_state(), gpu._frames_written,
                          gpu._sem_frames_live())
  host = live._replace(**{k: v.cpu() for k, v in live._asdict().items()
                          if k != 'cursor'})
  size = (cfg.image_height, 2 * cfg.image_height, cfg.depth_scale)
  for position in ([[0.3, 0.05, 0.0]], [[-0.2, 0.4, 0.1]]):
    position = torch.tensor(position)
    ref = inference.memory_project(host, position, *size)
    got = inference.memory_project(live, position.cuda(), *size)
    moved = ((got[2].cpu() != ref[2]).any(-1) | (got[0].cpu() != ref[0])[
        ..., 0] | (got[3].cpu() != ref[3])[..., 0])
    crossed, sqrt_off = pixels_apart(geometry, splat, live.rgb_coords,
                                     live.rgb, position, *size[:2])
    depth_off = int((got[1].cpu() != ref[1])[~(moved | crossed | sqrt_off)]
                    .sum())
    # What the repaired divide changed: the same z-buffer divided by a
    # Python scalar (a multiply by the reciprocal on the card).
    zbuf, _ = splat_cuda.splat_fast(
        geometry.equirect_view_coords(live.rgb_coords - torch.cat(
            [position, torch.zeros((1, 1))], 1).cuda()[..., None]),
        live.rgb, size[0], size[1], size[2], -1.0)
    clipped = torch.clamp(zbuf, 0.0, size[2])
    scalar_off = int((clipped / size[2] != clipped / torch.full(
        (), size[2], device='cuda')).sum())
    log(f'  splat stage at {position.tolist()[0]} on one memory: guidance '
        f'pixels moved {int(moved.sum())} of {moved.numel()}, pixels an RGB '
        f'point entered or left {int(crossed.sum())}, pixels of a point '
        f'whose radius the CPU\'s sqrt rounds off {int(sqrt_off.sum())}, '
        f'proj_depth off the CPU\'s bits on {depth_off} other pixels; a '
        f'Python-scalar divide would put {scalar_off} of {zbuf.numel()} '
        f'depth pixels off')
    if (moved | crossed).float().mean() > 0.005 or depth_off:
      raise AssertionError('card and CPU splat stages disagree')


def serving_config(model_config, **overrides):
  """Phase 4's production serving config (full width, bf16, 'fast')."""
  return dataclasses.replace(model_config.SE3DSConfig(
      ckpt_path=None, image_height=H, gen_dims=128, resnet_version='101',
      compute_dtype='bfloat16', memory_frames=8, splat_mode='fast'),
                             **overrides)


def phase_serving(inference, model_config, splat_cuda, power):
  log('== phase 4: full-width serving (1024x512, gen_dims 128, ResNet-101,'
      ' bf16) ==')
  cfg = serving_config(model_config)
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

  set_launches()
  zero_counters(EPILOGUE_COUNTERS + WRAP_COUNTERS)
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
  launches = tracing.count(FAST)
  frames = 6
  if launches != 2 * frames or tracing.count(EXACT):
    raise AssertionError(f'{launches} point-pass launches for {frames} '
                         'frames; expected 2 per frame (and no exact one, '
                         f'got {tracing.count(EXACT)})')
  epilogue_launches, fused, convs = (tracing.count(n)
                                     for n in EPILOGUE_COUNTERS)
  if not (fused == convs > 0 and epilogue_launches % frames == 0):
    raise AssertionError(f'{epilogue_launches} epilogue launches for '
                         f'{frames} frames, {fused} of {convs} convolution '
                         'outputs read by them (expected all)')
  wrap_launches, wrap_pads = (tracing.count(n) for n in WRAP_COUNTERS)
  if not (wrap_launches == wrap_pads > 0 and wrap_pads % frames == 0):
    raise AssertionError(f'{wrap_launches} wrap launches for {wrap_pads} '
                         f'circular pads in {frames} frames (expected one '
                         'each)')

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
  log(f'  splat point-pass launches on the main path: {launches} ({frames} '
      'frames)')
  log(f'  epilogue kernel launches on the main path: {epilogue_launches} '
      f'({epilogue_launches // frames} a frame), reading {fused} of the '
      f'{convs} convolution outputs')
  log(f'  wrap kernel launches on the main path: {wrap_launches} '
      f'({wrap_launches // frames} a frame), for {wrap_pads} circular pads')

  # The stage against its plain version on the main path's own inputs:
  # the memory as the next frame would splat it.
  mem = model._live_memory(model.get_memory_state(copy=False),
                           model._frames_written, model._sem_frames_live())
  from se3ds_torch import constants
  from se3ds_torch.ops import geometry
  pos = torch.tensor([[0.5, 0.0, 0.0, 0.0]], device='cuda')
  max_err, frame = 0.0, {}
  for name, xyz, feats, void, need_depth in (
      ('semantic', mem.coords, mem.feats, constants.INVALID_SEM_VALUE, False),
      ('rgb', mem.rgb_coords, mem.rgb, constants.INVALID_RGB_VALUE, True)):
    kernel, plain = fast_stage(geometry, xyz, feats, pos, float(void),
                               need_depth)
    max_err = max(max_err, equal_or_raise(f'main-path {name} splat',
                                          kernel(), plain()))
    t = fast_timings(splat_cuda, geometry, xyz, feats, pos, float(void),
                     need_depth)
    log_timings(f'main-path {name} splat ({xyz.shape[-1]} points, kernel '
                '== plain)', t, power)
    frame = {k: frame.get(k, 0.0) + v for k, v in t.items()}
  log_timings('main-path splat per served frame', frame, power)
  return launches, max_err, frame, epilogue_launches, wrap_launches


def epilogue_bytes(layers, x, residual, out):
  """The bytes the epilogue kernel reads and writes in the call
  `layers.epilogue(x, residual=residual)` that returned `out`: each
  operand and window sum once, in the output's dtype (as the kernel reads
  them), and its outputs once; the per-channel constants aside."""
  tensors = [x.out, x.window_sum, *out]
  if isinstance(residual, layers.ConvOutput):
    tensors += [residual.out, residual.window_sum]
  elif residual is not None:
    tensors.append(residual)
  return sum(t.numel() for t in tensors if t is not None) * (
      out[0].element_size())


def wrap_bytes(x, scale, out):
  """The bytes the wrap kernel reads and writes in the call
  `layers._padded(x, pads, scale)` that returned `out`: its input and its
  scale once, and its padded block once."""
  return sum(t.numel() for t in (x, scale, out) if t is not None) * (
      out.element_size())


def phase_generator_kernels(inference, model_config, power):
  log('== phase 4b: the conv epilogue and wrap kernels on the served '
      'generator\'s own calls against their plain bodies (1024x512, '
      'gen_dims 128, ResNet-101, bf16, batch 1 and 8) ==')
  from se3ds_torch.models import layers
  model = inference.SE3DSModel(
      serving_config(model_config), device='cuda',
      generator=torch.Generator(device='cuda').manual_seed(0),
      cuda_graphs=False)
  rgb, sem, depth = synthetic_pano(H, 0)
  model.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32),
                      mask_blurred=True)
  rs = np.random.RandomState(5)
  poses = rs.uniform(-0.8, 0.8, (POSES_K, 3)).astype(np.float32)
  poses[:, 2] *= 0.1
  position = np.array([[0.25, 0.1, 0.0]], np.float32)
  calls = {1: lambda: model(position),
           POSES_K: lambda: model.predict_poses(poses)}
  real, real_padded = layers.epilogue, layers._padded
  seen = {'epilogue': {}, 'wrap': {}}

  def note(kernel, out, want, nbytes, shape):
    """Holds one kernel call's outputs to its plain body's."""
    s = seen[kernel]
    s['max_err'] = max(s['max_err'], equal_or_raise(
        f'{kernel} call {s["calls"]} on {shape} {out[0].dtype}', out, want))
    s['calls'] += 1
    s['bytes'] += nbytes
    s['shapes'].add(shape[1:])

  def checked(x, act=None, residual=None, after_act=False, post_bn=None):
    before = tracing.count('epilogue.launches')
    out = real(x, act, residual, after_act, post_bn)
    if tracing.count('epilogue.launches') != before + 1:
      raise AssertionError(f'epilogue call {seen["epilogue"]["calls"]} on '
                           f'{tuple(x.out.shape)} launched no kernel')
    note('epilogue', out,
         layers.epilogue_plain(x, act, residual, after_act, post_bn),
         epilogue_bytes(layers, x, residual, out), tuple(x.out.shape))
    return out

  def plain(x, act=None, residual=None, after_act=False, post_bn=None):
    return layers.epilogue_plain(x, act, residual, after_act, post_bn)

  def plain_padded(x, pads, scale=None):
    """`layers._padded`'s plain body: it runs where autograd records."""
    with torch.enable_grad():
      return real_padded(x.detach().requires_grad_(), pads, scale).detach()

  def checked_padded(x, pads, scale=None):
    if not pads.wrap:
      return real_padded(x, pads, scale)
    before = tracing.count('wrap.launches')
    out = real_padded(x, pads, scale)
    if tracing.count('wrap.launches') != before + 1:
      raise AssertionError(f'wrap call {seen["wrap"]["calls"]} on '
                           f'{tuple(x.shape)} launched no kernel')
    note('wrap', [out], [plain_padded(x, pads, scale)],
         wrap_bytes(x, scale, out), tuple(x.shape))
    return out

  def patched(**fns):
    """Runs fn with these functions of `layers` in place of its own."""
    def run(fn):
      for name, f in fns.items():
        setattr(layers, name, f)
      try:
        return fn()
      finally:
        layers.epilogue, layers._padded = real, real_padded
    return run

  # Each kernel: the `layers` function that launches it, its plain body,
  # and its name in the profiler.
  kernels = {'epilogue': ('epilogue', plain, EPILOGUE_KERNEL),
             'wrap': ('_padded', plain_padded, WRAP_KERNEL)}
  results = {name: {} for name in kernels}
  for batch, fn in calls.items():
    fn()  # warm-up: cuDNN picks its algorithms
    sync()
    for s in seen.values():
      s.update(calls=0, bytes=0, max_err=0.0, shapes=set())
    zero_counters(EPILOGUE_COUNTERS + WRAP_COUNTERS)
    patched(epilogue=checked, _padded=checked_padded)(fn)
    sync()
    launches, fused, convs = (tracing.count(n) for n in EPILOGUE_COUNTERS)
    if not (launches == seen['epilogue']['calls'] > 0 and fused == convs):
      raise AssertionError(f'batch {batch}: {launches} epilogue launches in '
                           f'{seen["epilogue"]["calls"]} checked calls, '
                           f'{fused} of {convs} convolution outputs fused')
    # Each checked call's plain body counts its circular pad too.
    wraps, pads = (tracing.count(n) for n in WRAP_COUNTERS)
    pads -= seen['wrap']['calls']
    if not wraps == pads == seen['wrap']['calls'] > 0:
      raise AssertionError(f'batch {batch}: {wraps} wrap launches in '
                           f'{seen["wrap"]["calls"]} checked calls, for '
                           f'{pads} circular pads')
    log(f'  batch {batch}: {launches} epilogue launches reading {fused} of '
        f'{convs} convolution outputs, {wraps} wrap launches for {pads} '
        'circular pads')
    for name, (attr, plain_fn, kernel) in kernels.items():
      s = seen[name]
      call_ms, kernel_ms = profiled_ms(fn, kernel)
      plain_call_ms, left_ms = profiled_ms(
          lambda: patched(**{attr: plain_fn})(fn), kernel)
      if left_ms:
        raise AssertionError(f'the {name} kernel ran with the plain body in '
                             'its place')
      # The call's device time less its kernel's is the rest of the call,
      # which the plain body's call holds too.
      plain_ms = plain_call_ms - (call_ms - kernel_ms)
      bound_ms = s['bytes'] / HBM_BYTES_PER_S * 1e3
      channels = sorted(c for c, _, _ in s['shapes'])
      maps = sorted({(h, w) for _, h, w in s['shapes']})
      log(f'  batch {batch}, {name}: {s["calls"]} launches, every output '
          f'torch.equal to the plain body (max |d| {s["max_err"]}); C '
          f'{channels[0]} to {channels[-1]}, maps {maps[-1]} down to '
          f'{maps[0]}')
      log(f'  batch {batch}, {name}: kernel {kernel_ms:.4f} ms a call '
          f'({s["bytes"] / 1e9:.3f} GB, {s["bytes"] / kernel_ms / 1e9:.3f} '
          f'TB/s), bound {bound_ms:.4f} ms, plain body {plain_ms:.4f} ms; '
          f'the whole call {call_ms:.4f} ms, {plain_call_ms:.4f} ms with the '
          f'plain body ({power})')
      results[name][batch] = {'launches': s['calls'],
                              'max_err': s['max_err'], 'ms': kernel_ms,
                              'plain_ms': plain_ms, 'bound_ms': bound_ms}
  return results


def exact_stage(geometry, xyz, feats, offset, void, out_void, height=H,
                width=W, depth_scale=DEPTH_SCALE):
  """The exact stage, world memory to images, and its plain version."""
  from se3ds_torch.ops import splat
  kernel = lambda: splat.splat_images(
      True, xyz, feats, height, width, depth_scale, void, out_void,
      offset=offset)
  plain = lambda: splat.project_to_feat_plain(
      geometry.equirect_view_coords(xyz - offset[..., None]), feats, height,
      width, depth_scale, void, out_void)
  return kernel, plain


def exact_timings(splat_cuda, geometry, xyz, feats, offset, void, out_void):
  """Device ms of the cooperative launch (and of the same launch over
  precomputed view coordinates) and of the resolve, the whole stage
  (events, and device ms), the plain version (events), the bound,
  and the device ms of the 'fast' point pass on the same points (one
  read of them and one atomic per point), at full width."""
  kernel, plain = exact_stage(geometry, xyz, feats, offset, void, out_void)
  words = lambda: splat_cuda.exact_words(xyz, feats, H, W, DEPTH_SCALE, void,
                                         offset=offset)
  done = words()
  view = geometry.equirect_view_coords(xyz - offset[..., None])
  return {
      'point': device_ms(words),
      'view_point': device_ms(lambda: splat_cuda.exact_words(
          view, feats, H, W, DEPTH_SCALE, void)),
      'resolve': device_ms(lambda: splat_cuda.exact_resolve(
          done, DEPTH_SCALE, out_void)),
      'stage': time_ms(kernel, reps=20),
      'stage_device': device_ms(kernel),
      'plain': time_ms(plain, reps=3),
      'bound': stage_bytes(xyz, feats, True) / HBM_BYTES_PER_S * 1e3,
      'one_read': device_ms(lambda: splat_cuda.fast_words(
          xyz, feats, H, W, DEPTH_SCALE, void, offset=offset))}


def log_exact_timings(name, t, power):
  log_timings(name, t, power)
  log(f'    the one launch against the fast point pass over the same '
      f'points: {t["point"]:.4f} / {t["one_read"]:.4f} ms = '
      f'{t["point"] / t["one_read"]:.2f} reads of the points')


def phase_exact_parity(splat_cuda, geometry, power):
  log('== phase 5: the exact CUDA splat against its plain version ==')
  device = torch.device('cuda')
  max_err = 0.0
  offset = torch.tensor([[0.3, -0.2, 0.1, 0.0]], device=device)

  def compare_buffers(name, coords, feats, void, out_void, height=H,
                      width=W, depth_scale=DEPTH_SCALE):
    nonlocal max_err
    plain = splat_cuda.splat_exact_plain(coords, feats, height, width,
                                         depth_scale, void, out_void)
    max_err = max(max_err, equal_or_raise(name, splat_cuda.splat_exact(
        coords, feats, height, width, depth_scale, void, out_void), plain))
    hit = int((plain[1] != out_void).any(-1).sum())
    log(f'  {name}, view coordinates: equal ({coords.shape[0]}x'
        f'{coords.shape[-1]} points, {hit} pixels hit)')

  def compare_stage(name, xyz, feats, offset, void, out_void, **kw):
    nonlocal max_err
    kernel, plain = exact_stage(geometry, xyz, feats, offset, void, out_void,
                                **kw)
    max_err = max(max_err, equal_or_raise(name, kernel(), plain()))
    log(f'  {name}, world points: equal ({xyz.shape[0]}x{xyz.shape[-1]} '
        'points)')

  edges = edge_clouds(device)
  for name, (coords, feats) in edges.items():
    for out_void in (0.0, -1.0):
      compare_buffers(f'{name}, output void {out_void}', coords, feats, -1.0,
                      out_void, 64, 128)
      compare_stage(f'{name}, output void {out_void}', coords, feats, offset,
                    -1.0, out_void, height=64, width=128)
  base, feats = edges['void features']
  rs = np.random.RandomState(8)
  negative = torch.from_numpy(
      rs.randint(-40, 40, tuple(feats.shape)) / 4.0).float().to(device)
  compare_buffers('negative non-void features', base, negative, -1.0, -1.0,
                  32, 64)
  # Depths around depth_scale: the minimum clips to 20, the window tests
  # the raw depth against 20.1.
  depth = torch.from_numpy(rs.uniform(19.8, 20.6, base.shape[-1])).float()
  beyond = base * (depth.to(device) / base[:, 2])
  beyond[:, 3] = 1.0
  compare_buffers('beyond depth_scale', beyond, feats, -1.0, -1.0, 32, 64)
  compare_stage('beyond depth_scale', beyond, feats,
                torch.zeros((1, 4), device=device), -1.0, -1.0, height=32,
                width=64)

  # Collision-heavy full-width clouds: up to 4 frames per batch element
  # (the RGB cloud uncompacted, as the rollout memory holds it), taken as
  # slices of the whole memory (row stride != points).
  clouds, target = world_clouds(8, frames=4, seed=11, device=device,
                                compact=False)
  for xyz, feats, void in clouds:
    for batch in (1, 8):
      for frames in (1, 2, 4):
        extent = frames * H * W
        name = f'C={feats.shape[-1]} batch {batch} {frames} frames'
        compare_stage(name, xyz[:batch, :, :extent], feats[:batch, :extent],
                      target[:batch], void, -1.0)
    compare_buffers(f'C={feats.shape[-1]} batch 8 4 frames',
                    geometry.equirect_view_coords(xyz - target[..., None]),
                    feats, void, -1.0)
  xyz, feats, void = clouds[1]
  for frames in (1, 2, 4):
    extent = frames * H * W
    t = exact_timings(splat_cuda, geometry, xyz[:, :, :extent],
                      feats[:, :extent], target, void, -1.0)
    log_exact_timings(f'C=3 batch 8, {extent} points each', t, power)
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
  from se3ds_torch.eval import inception as inception_lib
  from se3ds_torch.eval import metrics
  cfg = model_config.SE3DSConfig(ckpt_path=None, image_height=H,
                                 gen_dims=128, resnet_version='101',
                                 compute_dtype='bfloat16')
  generator = eval_generator(inference, cfg, 'cuda', seed=0)
  t0 = time.perf_counter()
  video = synthetic_video(EVAL_BATCH, EVAL_FRAMES, H, 1)
  log(f'  synthetic video batch made in {time.perf_counter() - t0:.2f} s')
  depth_scale = constants.DEPTH_SCALE

  # Warm-up rollout (cuDNN picks its algorithms), which also records the
  # splat stage's inputs of each frame; then the timed one, through the
  # real stage with nothing recorded.
  from se3ds_torch.ops import geometry
  recorded = []
  stage = geometry.project_memory_equirect

  def recording(feats, xyz, offset, *args, **kwargs):
    recorded.append((feats.clone(), xyz.clone(), offset.clone()))
    return stage(feats, xyz, offset, *args, **kwargs)

  geometry.project_memory_equirect = recording
  try:
    metrics.rollout_generated(generator, video, EVAL_FRAMES, depth_scale,
                              device='cuda')
  finally:
    geometry.project_memory_equirect = stage
  sync()
  set_launches()
  t0 = time.perf_counter()
  generated, rmse, aux = metrics.rollout_generated(
      generator, video, EVAL_FRAMES, depth_scale, device='cuda')
  sync()
  rollout_s = time.perf_counter() - t0
  rollout_launches = tracing.count(EXACT)
  if rollout_launches != EVAL_FRAMES or tracing.count(FAST):
    raise AssertionError(f'{rollout_launches} exact launches for '
                         f'{EVAL_FRAMES} frames (expected 1 per frame), '
                         f'{tracing.count(FAST)} fast ones (expected 0)')
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

  # Inception on a generated frame (the FID itself runs in phase 8,
  # through Trainer.test).
  rng = torch.Generator(device='cuda').manual_seed(0)
  inception = inception_lib.init_inception(
      torch.Generator(device='cuda').manual_seed(42))
  crop = metrics._augment_crop_for_inception(generated[1], rng)
  inception_ms = time_ms(lambda: inception_lib.get_inception(
      crop, inception), reps=10)
  log(f'  Inception: {inception_ms:.3f} ms per batch of {EVAL_BATCH} '
      f'({tuple(crop.shape[1:3])} -> 299x299) ({power})')

  # The stage on the rollout's own inputs, frame by frame.
  max_err, frame_times = 0.0, []
  void = float(constants.INVALID_RGB_VALUE)
  for i, (feats, xyz, offset) in enumerate(recorded):
    kernel, plain = exact_stage(geometry, xyz, feats, offset, void, 0.0)
    max_err = max(max_err, equal_or_raise(f'rollout frame {i}', kernel(),
                                          plain()))
    t = exact_timings(splat_cuda, geometry, xyz, feats, offset, void, 0.0)
    log_exact_timings(f'rollout frame {i} ({EVAL_BATCH}x{xyz.shape[-1]} '
                      'points, kernel == plain)', t, power)
    frame_times.append(t)
  per_frame = {k: statistics.mean(t[k] for t in frame_times)
               for k in frame_times[0]}
  log_timings(f'exact splat per rollout frame (mean of {len(recorded)})',
              per_frame, power)
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


TRAIN_CHUNK = 16  # one card's share of lowres train_batch_size=128 on 8
TRAIN_STEPS = 4  # one warm-up step and 3 timed steps
HIGHRES_GIN = os.path.join(REPO, 'configs', 'highres', 'highres.gin')
# The largest chunk that trains without remat (found with
# `python -m se3ds_torch.profile_training --gin configs/highres/highres.gin
# --chunk N`, one process per N; PERF.md section 6, PR 7).
HIGHRES_CHUNK = 4
HIGHRES_REMAT_CHUNK = 8  # one card's share of highres train_batch_size 64 on 8
TF32_PEAK = 495e12  # H100 SXM dense TF32 FLOP/s (data sheet)


def watched_train(gin, chunk, power, remat=False):
  """`Trainer.train` on synthetic batches at a recipe's full width
  (its gin file; one card's `chunk` a chunk, TRAIN_STEPS steps of one
  cluster), float32 with TF32 convs. Times each of the trainer's own
  `train_cluster` calls (synchronised), checks every metric finite, the
  parameters moved and the EMA assigned then decayed, counts the step's
  FLOPs and returns (trainer, state, median ms, model_dir)."""
  import tempfile
  from se3ds_torch import config as config_lib
  from se3ds_torch.train import checkpoints as ckpt_lib
  from se3ds_torch.train import state as state_lib
  from se3ds_torch.train import trainer as trainer_lib
  torch.backends.cudnn.allow_tf32 = True
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  os.makedirs(BUILD_DIR, exist_ok=True)
  model_dir = tempfile.mkdtemp(prefix='train_', dir=BUILD_DIR)
  # The recipe's values and widths from its gin file; the batch and the
  # schedule cut to one card and a few steps.
  config_lib.clear_config()
  config_lib.parse_config_files_and_bindings([gin])
  trainer = config_lib.apply_config(
      'GAN', model_dir=model_dir, train_batch_size=chunk,
      num_batched_steps=1, log_every_steps=1,
      save_every_steps=10 * TRAIN_STEPS, remat=remat, device='cuda')
  batches = trainer_lib.synthetic_batches(2 * chunk, trainer.image_size, 0)

  # Watch the trainer's own cluster calls: time each (synchronised), keep
  # its metrics, and check the parameters and the EMA around them.
  cluster = state_lib.train_cluster
  seen = {'ms': [], 'metrics': []}

  def watched(state, stacked, hp):
    if not seen['ms']:  # host copies: they must not count in the peak
      seen['before'] = {
          'g': [p.detach().to('cpu', copy=True)
                for p in state.generator.parameters()],
          'd': [p.detach().to('cpu', copy=True)
                for p in state.discriminator.parameters()]}
      seen['params'] = (
          sum(p.numel() for p in state.generator.parameters()),
          sum(p.numel() for p in state.discriminator.parameters()))
    sync()
    t0 = time.perf_counter()
    metrics = cluster(state, stacked, hp)
    sync()
    seen['ms'].append((time.perf_counter() - t0) * 1e3)
    seen['metrics'].append({k: float(v) for k, v in metrics.items()})
    ema_equal = all(torch.equal(e, g) for e, g in zip(
        [*state.ema.parameters(), *state.ema.buffers()],
        [*state.generator.parameters(), *state.generator.buffers()]))
    seen.setdefault('ema_equal', []).append(ema_equal)
    return metrics

  save = ckpt_lib.CheckpointManager.save

  def timed_save(manager, step, state):
    t0 = time.perf_counter()
    save(manager, step, state)
    seen['save_s'] = time.perf_counter() - t0

  state_lib.train_cluster = watched
  ckpt_lib.CheckpointManager.save = timed_save
  t0 = time.perf_counter()
  try:
    state = trainer.train(batches, TRAIN_STEPS)
  finally:
    state_lib.train_cluster = cluster
    ckpt_lib.CheckpointManager.save = save
  sync()
  train_s = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated()
  g_params, d_params = seen['params']
  log(f'  parameters: G {g_params:,}, D {d_params:,}')
  for i, (ms, metrics) in enumerate(zip(seen['ms'], seen['metrics'])):
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad:
      raise AssertionError(f'step {i}: non-finite metrics {bad}')
    log(f'  step {i}{" (warm-up)" if i == 0 else ""}: {ms:.2f} ms; ' +
        ', '.join(f'{k} {v:.6g}' for k, v in sorted(metrics.items())))
  timed = seen['ms'][1:]
  median = statistics.median(timed)
  # A batch's shapes (the stream itself may still be in the trainer's
  # prefetch thread).
  channels = {'image': 3, 'depth': 1, 'proj_image': 3, 'proj_depth': 1,
              'proj_mask': 1, 'blurred_mask': 1}
  flops = trainer.step_flops({
      k: np.empty((2 * chunk, trainer.image_size, 2 * trainer.image_size, c),
                  np.float32) for k, c in channels.items()})
  log(f'  ms per step of {2 * chunk} examples ({chunk} per chunk, 1 D-only '
      f'+ 1 G+D update, remat {remat}), {len(timed)} timed steps: {timed} '
      f'-> median {median:.2f} ms, {2 * chunk / median * 1e3:.2f} '
      f'examples/sec ({power})')
  log(f'  FLOPs per step (utils/flops.py, matmuls and convs'
      f'{", the recompute included" if remat else ""}): {flops:.6g} -> '
      f'{flops / median / 1e9:.2f} TFLOP/s, '
      f'{flops / median * 1e3 / TF32_PEAK:.4f} of the dense TF32 peak')
  log(f'  peak device memory {peak / 2**30:.2f} GiB; Trainer.train '
      f'{train_s:.2f} s, of which its final checkpoint {seen["save_s"]:.2f} s')
  moved = {}
  for part, module in (('g', state.generator), ('d', state.discriminator)):
    deltas = [float((p.detach().cpu() - q).abs().max())
              for p, q in zip(module.parameters(), seen['before'][part])]
    moved[part] = sum(d > 0 for d in deltas)
    log(f'  {part.upper()}: {moved[part]} of {len(deltas)} parameter '
        f'tensors moved, largest change {max(deltas):.3g}')
    if moved[part] < 0.9 * len(deltas):
      raise AssertionError(f'{part} parameters did not move')
  if seen['ema_equal'] != [True] + [False] * (TRAIN_STEPS - 1):
    raise AssertionError(f'EMA equal to G after each step: '
                         f'{seen["ema_equal"]}, expected the assign step '
                         'then the decay steps')
  log('  EMA equals G after step 0 (assign) and differs after steps 1-3 '
      '(decay)')
  del seen['before']

  steps = ckpt_lib.CheckpointManager(model_dir).all_steps()
  size = sum(os.path.getsize(os.path.join(root, f))
             for root, _, files in os.walk(model_dir) for f in files)
  if steps != [TRAIN_STEPS] or not os.path.exists(
      os.path.join(model_dir, 'TRAIN_DONE')):
    raise AssertionError(f'checkpoints {steps}, TRAIN_DONE missing?')
  log(f'  final checkpoint at step {steps[0]}: {size / 2**30:.2f} GiB on disk'
      ' (with the event file), TRAIN_DONE written')
  shutil.rmtree(model_dir)
  return trainer, state, median


def phase_train(power):
  log('== phase 7: full-width lowres training (256x128, gen_dims 128, '
      'ResNet-101, D dis_dims 128 n_dis 2 n_layers 6, float32) ==')
  log('  TF32 on for cuDNN convolutions (PyTorch\'s default; matmuls stay '
      'float32)')
  trainer, state, _ = watched_train(LOWRES_GIN, TRAIN_CHUNK, power)
  t0 = time.perf_counter()
  grid, _ = trainer.get_image_grid(state, 'train')
  grid_s = time.perf_counter() - t0
  for key, image in grid.items():
    if image.dtype != np.uint8 or image.shape[0] != 1:
      raise AssertionError(f'{key}: {image.shape} {image.dtype}')
  log(f'  train image grid: {len(grid)} images of '
      f'{grid["train_raw_generated"].shape[1:]} in {grid_s:.2f} s')
  torch.backends.cudnn.allow_tf32 = False
  del state, trainer
  torch.cuda.empty_cache()


def tiny_trainer(device, model_dir):
  """The trainer at the sizes of tests/test_train.py."""
  from se3ds_torch.models import discriminator as disc_lib
  from se3ds_torch.models import generator as gen_lib
  from se3ds_torch.train import trainer as trainer_lib
  return trainer_lib.Trainer(
      model_dir, image_size=32, seed=0, beta1=0.5, g_lr=1e-4, d_lr=4e-4,
      train_batch_size=2, d_step_per_g_step=2, num_batched_steps=2,
      predict_depth=True, mask_blurred=True,
      generator_fn=lambda image_size: gen_lib.ResNetGenerator(
          gen_dims=2, z_dim=2, resnet_version='tiny', spectral_fold=False),
      discriminator_fn=lambda image_size: disc_lib.SNMultiScaleDiscriminator(
          n_dis=2, dis_dims=2, n_layers=3),
      device=device)


# Card against the CPU after one tiny train step, TF32 off. At this size
# the train-mode BatchNorms normalise over 4 elements per channel at the
# 1x2 bottleneck, which amplifies float32 rounding: on these inputs the
# port's own float32 step on the CPU differs from its float64 step by
# 7e-4 to 1.4e-3 of the largest first Adam moment and by up to 1e-4 in
# the gradient-norm metric, by CPU and PyTorch version (the phase prints
# it). Tolerances: the moments 3e-3 of the largest,
# the metrics rtol 1e-3, parameters 1e-5 (a tenth of G's Adam step)
# where |first moment| >= 1e-3 of the largest (state_differences),
# BatchNorm statistics and u 1e-5.
TINY_TOLERANCES = {'params': 1e-5, 'stats': 1e-5, 'u': 1e-5,
                   'exp_avg': 3e-3, 'exp_avg_sq': 3e-3, 'adam_steps': 0.0}
TINY_METRIC_RTOL = 1e-3


def phase_train_small_vs_cpu():
  log('== phase 7b: tiny train step, card against the CPU (TF32 off) ==')
  import tempfile
  from se3ds_torch.train import checkpoints as ckpt_lib
  from se3ds_torch.train import state as state_lib
  from se3ds_torch.train import trainer as trainer_lib
  torch.backends.cudnn.allow_tf32 = False
  model_dir = tempfile.mkdtemp(prefix='train_tiny_', dir=BUILD_DIR)
  trainers = [tiny_trainer(d, model_dir) for d in ('cpu', 'cuda')]
  states = [t.create_state() for t in trainers]
  ckpt_lib.load_bundle(states[1], ckpt_lib.state_bundle(states[0]))
  start = copy.deepcopy(ckpt_lib.state_bundle(states[0]))
  batch = next(trainer_lib.synthetic_batches(4, 32, 1))
  metrics = [state_lib.train_step(s, t.device_batch(batch), t.hp)
             for s, t in zip(states, trainers)]
  # The same step on the CPU in float64: the float32 rounding of this
  # computation, which the tolerances are set from.
  exact = trainers[0].create_state()
  ckpt_lib.load_bundle(exact, start)
  for module in (exact.generator, exact.discriminator, exact.ema):
    module.double()
  exact.generator.dtype = exact.ema.dtype = torch.float64
  exact.g_opt, exact.d_opt = state_lib.make_optimizers(
      exact.generator, exact.discriminator, 1e-4, 4e-4, 0.5, 0.999)
  exact_metrics = state_lib.train_step(exact, {
      k: v.double() for k, v in trainers[0].device_batch(batch).items()},
                                       trainers[0].hp)
  for name, (got, want, a, b) in (
      ('CPU float32 against float64', (metrics[0], exact_metrics,
                                       states[0], exact)),
      ('card against the CPU', (metrics[1], metrics[0], states[1],
                                states[0]))):
    rel = {k: abs(float(got[k]) - float(want[k]))
           / max(abs(float(want[k])), 1e-6) for k in want}
    diffs = state_lib.state_differences(a, b)
    log(f'  {name}: metrics, largest relative difference '
        f'{max(rel.values()):.3g} ({max(rel, key=rel.get)}); state: '
        + ', '.join(f'{k} {v:.3g}' for k, v in sorted(diffs.items())))
  over = [k for k, v in rel.items() if v > TINY_METRIC_RTOL] + [
      k for k, v in diffs.items()
      if v > TINY_TOLERANCES.get(k.split('_', 1)[-1], float('inf'))]
  if over:
    raise AssertionError(f'card and CPU train steps disagree: {over}')
  log(f'  within tolerances: metrics rtol {TINY_METRIC_RTOL}, '
      f'{TINY_TOLERANCES}')

  manager = ckpt_lib.CheckpointManager(model_dir)
  manager.save(states[1].step, states[1])
  restored = trainers[1].create_state()
  manager.restore(restored)
  saved, back = (ckpt_lib.state_bundle(s) for s in (states[1], restored))
  if not ckpt_lib.bundles_equal(saved, back):
    raise AssertionError('checkpoint round trip on the card is not '
                         'bit-equal')
  log(f'  checkpoint round trip on the card at step {restored.step}: every '
      'tensor torch.equal')
  shutil.rmtree(model_dir)


# Phase 8: the lowres recipe through the CLI. Image pairs at the recipe's
# stored height, enough distinct records for one step (2 chunks of 16);
# the eval videos stored at the model's 128 (a cut: the resize is then
# the identity), 8 of them, one card's share of test_batch_size 64.
CLI_IMAGE_HEIGHT = 1024
CLI_TRAIN_FILES, CLI_RECORDS_PER_FILE = 8, 4
CLI_VIDEO_FILES, CLI_VIDEOS_PER_FILE = 2, 4
CLI_VIDEO_HEIGHT = 128
CLI_STEPS = 4
CLI_EVAL_FRAMES = 4  # Trainer.eval_seq_len's default (lowres.gin keeps it)


def write_fixture(task):
  """Writes one fixture file (a worker process's task)."""
  kind, path, kwargs = task
  from se3ds_torch.data import synthetic
  getattr(synthetic, f'write_{kind}_fixture')(path, **kwargs)
  return os.path.getsize(path)


def event_scalars(model_dir):
  """[(step, tag, value)] of the scalar summaries in the event files."""
  import glob
  import struct
  from se3ds_torch.data import example_pb
  from se3ds_torch.data import tfrecord
  fields = lambda b: example_pb.iter_fields(b, 0, len(b))
  out = []
  for path in sorted(glob.glob(os.path.join(model_dir,
                                            'events.out.tfevents.*'))):
    for record in tfrecord.read_records(path):
      event = list(fields(record))
      step = next((v for f, v in event if f == 2), 0)
      for field, summary in event:
        if field != 5:  # Event.summary
          continue
        for _, value in fields(summary):
          value = dict(fields(value))
          if 2 in value:  # Value.simple_value
            out.append((step, bytes(value[1]).decode(),
                        struct.unpack('<f', value[2])[0]))
  return out


def cli_decode_timings(data, power):
  """Host ms per training example, decode then train transform, on each
  record path the machine has, and one video's decode + eval transform;
  the native and Python decodes must agree bit for bit."""
  import itertools
  from se3ds_torch import config as config_lib
  from se3ds_torch.data import datasets
  from se3ds_torch.data import native_loader
  from se3ds_torch.data import tfrecord
  from se3ds_torch.train import trainer  # noqa: F401 (registers the data)
  config_lib.clear_config()
  config_lib.parse_config_files_and_bindings([LOWRES_GIN])
  image_ds = config_lib.apply_config('R2RImageDataset', image_size=128)
  raws = list(itertools.islice(tfrecord.read_records(
      os.path.join(data, 'train-0.tfrecord')), 4))
  paths = {'python': lambda raw: datasets._decode_image_example(
      raw, CLI_IMAGE_HEIGHT)}
  native = native_loader.available()
  if native:
    paths['native'] = lambda raw: native_loader.decode_image_example(
        raw, CLI_IMAGE_HEIGHT)
    a, b = (paths[k](raws[0]) for k in ('native', 'python'))
    for key in a:
      if key not in ('filename', 'scan_id') and not np.array_equal(a[key],
                                                                   b[key]):
        raise AssertionError(f'native and Python decodes differ: {key}')
  log(f'  record and PNG path serving the pipeline: '
      f'{"native (se3ds_torch/csrc/dataloader.cc)" if native else "Python"}'
      f'; native and Python decodes bit-equal: {native or "not run"}')
  for name, parse in paths.items():
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    decoded = [parse(raw) for raw in raws]
    t1 = time.perf_counter()
    for features in decoded:
      image_ds._train_transform_fn(features, rng)
    t2 = time.perf_counter()
    per = lambda seconds: seconds * 1e3 / len(raws)
    log(f'  host ms per training example ({name} path, {CLI_IMAGE_HEIGHT}x'
        f'{2 * CLI_IMAGE_HEIGHT} record, {len(raws)} examples): decode '
        f'{per(t1 - t0):.1f}, train transform {per(t2 - t1):.1f} ({power})')
  video_ds = datasets.R2RVideoDataset(
      image_size=128, preprocessed_image_height=CLI_VIDEO_HEIGHT)
  raw = next(tfrecord.read_records(os.path.join(data, 'val_seen-0.tfrecord')))
  t0 = time.perf_counter()
  features = video_ds._eval_transform_fn(video_ds._parse(raw),
                                         np.random.RandomState(0))
  video_ms = (time.perf_counter() - t0) * 1e3
  log(f'  host ms per eval video (8 frames at {CLI_VIDEO_HEIGHT}x'
      f'{2 * CLI_VIDEO_HEIGHT}, decode + eval transform): {video_ms:.1f}; its '
      f'one-hot mask {features["one_hot_mask"].nbytes / 2**20:.1f} MiB')


def cli_argv(data, model_dir):
  """Phase 8's flags of `python -m se3ds_torch.main` but --mode."""
  bindings = [
      f"R2RImageDataset.data_dir = '{data}/'",
      f"R2RVideoDataset.data_dir = '{data}/'",
      f'R2RVideoDataset.preprocessed_image_height = {CLI_VIDEO_HEIGHT}',
      'GAN.num_epochs = 1',
      # 4 steps of 2 chunks of 16 make the epoch.
      'R2RImageDataset.num_examples_override = '
      f"{{'train': {CLI_STEPS * 2 * TRAIN_CHUNK}, 'val': 8}}",
      f'GAN.train_batch_size = {TRAIN_CHUNK}', 'GAN.num_batched_steps = 1',
      'GAN.log_every_steps = 1', f'GAN.save_every_steps = {CLI_STEPS}',
      f'GAN.eval_every_steps = {CLI_STEPS}',
      'GAN.test_batch_size = 8', 'GAN.eval_size = 8', 'GAN.eval_avg_num = 1']
  argv = ['--model_dir', model_dir, '--gin_config', LOWRES_GIN]
  for binding in bindings:
    argv += ['--gin_bindings', binding]
  return argv


def phase_cli(splat_cuda, power):
  log('== phase 8: the CLI on the lowres recipe, TRAIN then TEST ==')
  import concurrent.futures
  import csv
  import multiprocessing
  import resource
  import tempfile
  from se3ds_torch import main as main_lib
  from se3ds_torch.eval import fid as fid_lib
  from se3ds_torch.eval import metrics
  from se3ds_torch.ops import geometry
  from se3ds_torch.train import checkpoints as ckpt_lib
  from se3ds_torch.train import trainer as trainer_lib
  os.makedirs(BUILD_DIR, exist_ok=True)
  root = tempfile.mkdtemp(prefix='cli_', dir=BUILD_DIR)
  data, model_dir = os.path.join(root, 'data'), os.path.join(root, 'model')
  os.makedirs(data)

  tasks = [('image', os.path.join(data, f'train-{i}.tfrecord'),
            dict(num_examples=CLI_RECORDS_PER_FILE, height=CLI_IMAGE_HEIGHT,
                 seed=i)) for i in range(CLI_TRAIN_FILES)]
  tasks += [('video', os.path.join(data, f'val_seen-{i}.tfrecord'),
             dict(num_examples=CLI_VIDEOS_PER_FILE, height=CLI_VIDEO_HEIGHT,
                  seed=100 + i)) for i in range(CLI_VIDEO_FILES)]
  workers = min(len(tasks), os.cpu_count() or 1)
  t0 = time.perf_counter()
  with concurrent.futures.ProcessPoolExecutor(
      max_workers=workers,
      mp_context=multiprocessing.get_context('spawn')) as pool:
    sizes = list(pool.map(write_fixture, tasks))
  write_s = time.perf_counter() - t0
  records = CLI_TRAIN_FILES * CLI_RECORDS_PER_FILE
  record_mb = sum(sizes[:CLI_TRAIN_FILES]) / records / 1e6
  log(f'  fixtures: {records} image-pair records at {CLI_IMAGE_HEIGHT}x'
      f'{2 * CLI_IMAGE_HEIGHT} ({record_mb:.1f} MB each), '
      f'{CLI_VIDEO_FILES * CLI_VIDEOS_PER_FILE} videos at {CLI_VIDEO_HEIGHT}x'
      f'{2 * CLI_VIDEO_HEIGHT}, written in {write_s:.2f} s by {workers} '
      'processes')
  cli_decode_timings(data, power)

  argv = cli_argv(data, model_dir)

  # TRAIN through the real CLI, in its own process.
  train_log = os.path.join(root, 'train.log')
  t0 = time.perf_counter()
  with open(train_log, 'w') as out:
    proc = subprocess.run(
        [sys.executable, '-m', 'se3ds_torch.main', '--mode', 'TRAIN', *argv],
        cwd=REPO, stdout=out, stderr=subprocess.STDOUT, timeout=900,
        check=False)
  train_s = time.perf_counter() - t0
  if proc.returncode:
    with open(train_log) as f:
      log(''.join(f.readlines()[-40:]))
    raise AssertionError(f'python -m se3ds_torch.main --mode TRAIN exited '
                         f'{proc.returncode}')
  train_rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20
  scalars = event_scalars(model_dir)
  bad = [(step, tag) for step, tag, v in scalars if not np.isfinite(v)]
  rates = [(step, v) for step, tag, v in scalars if tag == 'steps_per_sec']
  if bad or len(rates) != CLI_STEPS:
    raise AssertionError(f'TRAIN logged {len(rates)} steps, non-finite {bad}')
  log(f'  TRAIN (python -m se3ds_torch.main, G gen_dims 128 ResNet-101, D '
      f'dis_dims 128, {2 * TRAIN_CHUNK} examples a step, TF32 convs): '
      f'{train_s:.2f} s wall; steps/sec as logged: '
      + ', '.join(f'step {s} {v:.4f} ({1e3 / v:.1f} ms)' for s, v in rates)
      + f'; peak host RSS of a child process {train_rss:.2f} GiB ({power})')
  steps = ckpt_lib.CheckpointManager(model_dir).all_steps()
  if steps != [CLI_STEPS] or not ckpt_lib.is_training_done(model_dir):
    raise AssertionError(f'checkpoints {steps}, TRAIN_DONE missing?')

  # TEST in this process, its parts timed and the splat stage recorded.
  seen = {'restore': [], 'grid': [], 'pngs': [], 'fid_score': [],
          'host_fid': [], 'moved': None, 'stage': []}
  saved = [(ckpt_lib.CheckpointManager, 'restore'),
           (trainer_lib.Trainer, 'get_image_grid'),
           (trainer_lib.Trainer, 'save_eval_images'),
           (metrics.EvalMetric, 'calculate_fid_score'),
           (fid_lib, 'calculate_fid'), (geometry, 'project_memory_equirect')]
  saved = [(owner, name, getattr(owner, name)) for owner, name in saved]
  real = {name: fn for _, name, fn in saved}

  def timed(key, fn):
    def call(*args, **kwargs):
      sync()
      t = time.perf_counter()
      out = fn(*args, **kwargs)
      sync()
      seen[key].append(time.perf_counter() - t)
      return out
    return call

  def restore(manager, state, step=None):
    before = [p.detach().clone() for p in (*state.generator.parameters(),
                                           *state.discriminator.parameters())]
    out = timed('restore', real['restore'])(manager, state, step)
    after = (*state.generator.parameters(), *state.discriminator.parameters())
    seen['moved'] = (sum(not torch.equal(a, b) for a, b in zip(after, before)),
                     len(before))
    return out

  def stage(*args, **kwargs):
    if len(seen['stage']) < CLI_EVAL_FRAMES and seen['grid_open']:
      seen['stage'].append((
          [a.clone() if torch.is_tensor(a) else a for a in args], kwargs))
    return real['project_memory_equirect'](*args, **kwargs)

  def grid(*args, **kwargs):
    seen['grid_open'] = True
    try:
      return timed('grid', real['get_image_grid'])(*args, **kwargs)
    finally:
      seen['grid_open'] = False

  seen['grid_open'] = False
  wrappers = {'restore': restore, 'get_image_grid': grid,
              'save_eval_images': timed('pngs', real['save_eval_images']),
              'calculate_fid_score': timed('fid_score',
                                           real['calculate_fid_score']),
              'calculate_fid': timed('host_fid', real['calculate_fid']),
              'project_memory_equirect': stage}
  torch.backends.cudnn.allow_tf32 = True
  torch.cuda.empty_cache()
  for owner, name, _ in saved:
    setattr(owner, name, wrappers[name])
  try:
    set_launches()
    t0 = time.perf_counter()
    main_lib.main(['--mode', 'TEST', '--device', 'cuda', *argv])
    sync()
    test_s = time.perf_counter() - t0
    launches, fast = tracing.count(EXACT), tracing.count(FAST)
  finally:
    for owner, name, fn in saved:
      setattr(owner, name, fn)
    torch.backends.cudnn.allow_tf32 = False
  rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
  # The display grid's 2 rollouts, then 2 per calculate_fid_score
  # (eval_size // test_batch_size + 1 batches), one launch per frame.
  want = (2 + 2 * 2) * CLI_EVAL_FRAMES
  if launches != want or fast:
    raise AssertionError(f'TEST: {launches} exact launches (expected {want}),'
                         f' {fast} fast ones')
  log(f'  TEST ({main_lib.__name__}.main in this process, TF32 convs): '
      f'{test_s:.2f} s wall; restore {sum(seen["restore"]):.2f} s, image '
      f'grid {sum(seen["grid"]):.2f} s, PNG dumps {sum(seen["pngs"]):.2f} s, '
      f'calculate_fid_score {", ".join(f"{t:.2f}" for t in seen["fid_score"])}'
      f' s (of which {len(seen["host_fid"])} host FIDs '
      f'{sum(seen["host_fid"]):.2f} s); exact-splat launches {launches}; peak '
      f'host RSS of this process {rss:.2f} GiB ({power})')
  moved, total = seen['moved']
  if moved < 0.9 * total:
    raise AssertionError(f'only {moved} of {total} parameter tensors moved')
  log(f'  the restored step-{CLI_STEPS} state: {moved} of {total} G and D '
      'parameter tensors differ from the seed-0 initialisation')

  with open(os.path.join(model_dir, 'scores_val_seen.csv')) as f:
    rows = list(csv.DictReader(f))
  keys = [f'val_seen/eval_image/{m}@{i}' for i in range(1, CLI_EVAL_FRAMES)
          for m in ('fid', 'ema_fid', 'rmse', 'ema_rmse', 'inception_score',
                    'ema_inception_score')]
  if (len(rows) != 1 or rows[0]['step'] != str(CLI_STEPS)
      or not all(np.isfinite(float(rows[0].get(k, 'nan'))) for k in keys)):
    raise AssertionError(f'scores_val_seen.csv: {rows}')
  log('  scores_val_seen.csv: ' + ', '.join(
      f'{k.split("/")[-1]} {rows[0][k]}' for k in keys))
  image_dir = os.path.join(model_dir, 'images', 'val_seen', str(CLI_STEPS))
  missing = [f'{frame}/{example}_{kind}.png'
             for frame in range(CLI_EVAL_FRAMES) for example in range(8)
             for kind in ('rgb', 'depth')
             if not os.path.exists(os.path.join(image_dir, str(frame),
                                                f'{example}_{kind}.png'))]
  if missing:
    raise AssertionError(f'PNG dumps missing: {missing}')
  log(f'  PNG dumps: {CLI_EVAL_FRAMES} frames x 8 examples x (rgb, depth) '
      f'under images/val_seen/{CLI_STEPS}/')

  # One rollout frame of the display batch: the stage's guidance on the
  # card against its plain version, on the rollout's own inputs.
  args, kwargs = seen['stage'][2]
  max_err = equal_or_raise(
      'display-batch rollout frame 2',
      geometry.project_memory_equirect(*args, **kwargs),
      geometry.project_memory_equirect_plain(*args, **kwargs))
  log(f'  display-batch rollout frame 2 ({args[1].shape[0]}x'
      f'{args[1].shape[-1]} points): exact splat == plain version')
  # The caller deletes `root` after phase 9 has served its checkpoint.
  return launches, max_err, model_dir, root


# Device accumulators of the splat-stage checks captured into CUDA graphs
# (mismatching values, max |d|, stages checked). They live for the whole
# run: a graph captured under one CheckedStage writes them at every
# replay, under any later one.
CAPTURED_CHECKS = {}


class CheckedStage:
  """While active, every call of `geometry.project_memory_equirect` (the
  splat stage of the main path) is held against its plain version on the
  same inputs, torch.equal, at once (the memory is written in place by
  the next step). The comparisons' seconds are kept apart so that the
  caller can take them off its step times; they launch no kernel.

  A call made while a CUDA graph is captured (the second call of a
  serving program's key) captures its check with it: the plain version
  and the comparison then run on the device at every replay, into
  CAPTURED_CHECKS, which `__exit__` reads (and raises on a mismatch). A
  replayed step's time includes its checks."""

  def __init__(self, geometry):
    self.geometry = geometry
    self.stage = geometry.project_memory_equirect
    self.calls, self.max_err, self.check_s = 0, 0.0, 0.0
    self.strides = []
    if not CAPTURED_CHECKS:
      CAPTURED_CHECKS.update(
          bad=torch.zeros((), dtype=torch.int64, device='cuda'),
          err=torch.zeros((), dtype=torch.float32, device='cuda'),
          calls=torch.zeros((), dtype=torch.int64, device='cuda'))

  def _captured_check(self, out, want):
    pairs = [(k, p) for k, p in zip(out, want)
             if k is not None and k.numel()]
    for k, p in pairs:
      CAPTURED_CHECKS['bad'] += (k != p).sum()
      CAPTURED_CHECKS['err'].copy_(torch.maximum(
          CAPTURED_CHECKS['err'], (k - p).abs().max()))
    CAPTURED_CHECKS['calls'] += 1

  def __enter__(self):
    sync()
    self.start = {k: int(v) for k, v in CAPTURED_CHECKS.items()
                  if k != 'err'}

    def checked(feats, xyz1, offset, *args, **kwargs):
      out = self.stage(feats, xyz1, offset, *args, **kwargs)
      plain_kwargs = {k: v for k, v in kwargs.items() if k != 'need_depth'}
      plain = lambda: self.geometry.project_memory_equirect_plain(
          feats, xyz1, offset, *args, **plain_kwargs)
      self.strides.append((feats.stride(0), xyz1.stride(0), xyz1.shape[0]))
      if torch.cuda.is_current_stream_capturing():
        self._captured_check(out, plain())
        return out
      sync()
      t0 = time.perf_counter()
      self.max_err = max(self.max_err, equal_or_raise(
          f'splat stage call {self.calls}', out, plain()))
      self.calls += 1
      self.check_s += time.perf_counter() - t0
      return out

    self.geometry.project_memory_equirect = checked
    return self

  def __exit__(self, *exc):
    self.geometry.project_memory_equirect = self.stage
    if exc[0] is not None:
      return
    sync()
    self.replayed = int(CAPTURED_CHECKS['calls']) - self.start['calls']
    self.calls += self.replayed
    self.max_err = max(self.max_err, float(CAPTURED_CHECKS['err']))
    bad = int(CAPTURED_CHECKS['bad']) - self.start['bad']
    if bad:
      raise AssertionError(f'{bad} values of replayed splat stages differ '
                           'from the plain version')


def timed_call(check, fn):
  """(result, ms of fn without the plain-version checks made on the host
  by `check`, a CheckedStage or None) after a sync."""
  sync()
  before = check.check_s if check else 0.0
  t0 = time.perf_counter()
  out = fn()
  sync()
  checks = (check.check_s - before) if check else 0.0
  return out, ((time.perf_counter() - t0) - checks) * 1e3


def drop_graphs(model, kind):
  """Forgets the model's captured graphs of one entry point (their keys
  stay warm): the next call of such a key captures it again."""
  model.graphs.graphs = {k: v for k, v in model.graphs.graphs.items()
                         if k[0][0] != kind}


def smooth_image(height, width, seed):
  """A smooth (H, W, 3) float32 image in [0, 255] and a (H, W, 1) depth
  in [0.1, 0.5]: what an RE10K frame and its depth look like to a warp."""
  rs = np.random.RandomState(seed)
  rows = np.linspace(0, np.pi, height, dtype=np.float32)[:, None, None]
  cols = np.linspace(0, np.pi, width, dtype=np.float32)[None, :, None]
  phase = rs.uniform(0, 2 * np.pi, (1, 1, 3)).astype(np.float32)
  rgb = 127.5 + 120 * np.sin(3 * cols + 2 * rows + phase)
  depth = 0.3 + 0.2 * np.sin(2 * cols) * np.cos(rows)
  return rgb.astype(np.float32), depth[..., :1].astype(np.float32)


# Batch 8 and batch 1 run different cuDNN algorithms in bf16, so the
# generator's outputs at predict_poses' batch K = 8 and at 8 single calls
# differ within a band: pred_rgb by at most POSES_RGB_LEVELS of 255 on at
# most POSES_RGB_SHARE of values, pred_depth by at most POSES_DEPTH_ATOL.
POSES_RGB_LEVELS, POSES_RGB_SHARE, POSES_DEPTH_ATOL = 8, 0.25, 0.05
# The perspective warp of a smooth 512x512 source on the card against the
# CPU: their trig rounds an ULP apart, which moves a bilinear sample by
# up to its gradient times the ULP of its coordinate (~6e-5 at 512).
WARP_ATOL = 0.05
RING_STEPS, RING_TRAJECTORY = 11, 3
POSES_K, PERTURBED_VIEWS = 8, 16


def phase_ring(inference, model_config, splat_cuda, geometry, power, pano):
  """(a) Ring memory across a wrap; returns (model, launches, max_err)."""
  frames = 8
  replays = tracing.count('serve.replays')
  model = inference.SE3DSModel(
      serving_config(model_config, memory_mode='ring'), device='cuda',
      generator=torch.Generator(device='cuda').manual_seed(0))
  rgb, sem, depth = pano
  mem = model.get_memory_state(copy=False)
  buffers = lambda m: [(t.data_ptr(), t.nbytes) for t in m[:4]]
  layout = buffers(mem)
  slots, step_ms = [], []
  set_launches()
  with CheckedStage(geometry) as check:
    _, add_ms = timed_call(check, lambda: model.add_to_memory(
        rgb, sem, depth, np.zeros((1, 3), np.float32)))
    allocated = {}
    for i in range(RING_STEPS):
      slots.append(model._next_write_slot())
      if slots[-1] == 0:
        allocated['before the wrap'] = torch.cuda.memory_allocated()
      _, ms = timed_call(check, lambda: model(
          np.array([[0.2 * (i + 1), 0.05 * i, 0.0]], np.float32),
          add_preds_to_memory=True))
      step_ms.append(ms)
    allocated['after the wrap'] = torch.cuda.memory_allocated()
    traj, traj_ms = timed_call(check, lambda: model.predict_trajectory(
        np.array([[2.5, 0.1 * t, 0.0] for t in range(RING_TRAJECTORY)],
                 np.float32)))
  launches = tracing.count(FAST)
  served = RING_STEPS + RING_TRAJECTORY
  if launches != 2 * served or tracing.count(EXACT):
    raise AssertionError(f'ring: {launches} fast point passes for {served} '
                         f'frames (expected 2 each)')
  if check.calls != 2 * served or buffers(model.get_memory_state(
      copy=False)) != layout:
    raise AssertionError(f'ring: {check.calls} checked stages, or the memory '
                         'buffers were reallocated')
  # Steps 4 and 6-11 replay graphs (the second call of a key captures).
  replays = tracing.count('serve.replays') - replays
  if not replays or check.replayed != 2 * replays:
    raise AssertionError(f'ring: {replays} replays, '
                         f'{check.replayed} replayed stages checked')
  if (model._frames_written, model._total_frames) != (
      frames, 1 + served) or not torch.isfinite(traj.pred_depth).all():
    raise AssertionError('ring: frame counters or outputs wrong')
  # Step 1 (cuDNN's set-up) is left out; step `frames` writes slot 0.
  before, after = step_ms[1:frames - 1], step_ms[frames - 1:]
  log(f'  (a) ring memory, {frames} frames: add {add_ms:.2f} ms, '
      f'{RING_STEPS} feedback steps writing slots {slots}; ms per step '
      f'before the wrap (steps 2-{frames - 1}) {statistics.mean(before):.2f}'
      f', from the wrap on (steps {frames}-{RING_STEPS}) '
      f'{statistics.mean(after):.2f}; all steps '
      f'{[round(m, 2) for m in step_ms]} (a replayed graph\'s time holds '
      f'its in-graph checks); predict_trajectory T={RING_TRAJECTORY} '
      f'{traj_ms:.2f} ms ({power})')
  log(f'  (a) every one of {check.calls} splat stages ({check.replayed} in '
      'replayed graphs, checked on the device) torch.equal to '
      'project_memory_equirect_plain on the card; memory buffers '
      f'{sum(n for _, n in layout) / 2**20:.1f} MiB, the same allocations '
      'before and after the wrap; device memory allocated '
      + ', '.join(f'{k} {v / 2**20:.1f} MiB' for k, v in allocated.items())
      + f' ({power})')
  return model, launches, check.max_err


def phase_poses(model, splat_cuda, geometry, power):
  """(b) predict_poses at K = 8 against 8 single calls."""
  rs = np.random.RandomState(5)
  poses = rs.uniform(-0.8, 0.8, (POSES_K, 3)).astype(np.float32)
  poses[:, 2] *= 0.1
  before = [t.clone() for t in model.get_memory_state(copy=False)[:4]]
  model.predict_poses(poses)  # warm-up: cuDNN picks its batch-8 algorithms
  model.predict_poses(poses)  # captures a graph without checks, replays it
  pool = model.graphs.pool_bytes()
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  _, poses_ms = timed_call(None, lambda: model.predict_poses(poses))
  peak = torch.cuda.max_memory_allocated()
  # Captured again with the splat stage's checks inside, and replayed; the
  # later phases on this model replay this graph, checks included.
  drop_graphs(model, 'poses')
  with CheckedStage(geometry) as check:
    set_launches()
    out = model.predict_poses(poses)
  launches = tracing.count(FAST)
  if (launches != 2 or check.strides != [(0, 0, POSES_K)] * 2
      or check.replayed != 2):
    raise AssertionError(f'predict_poses: {launches} launches, strides '
                         f'{check.strides} (expected 2 at batch stride 0), '
                         f'{check.replayed} replayed stages checked')
  model(poses[:1])  # warm-up at batch 1
  model(poses[:1])  # captures, without checks
  singles, single_ms = [], []
  for p in poses:
    one, ms = timed_call(None, lambda: model(p[None]))
    singles.append(one)
    single_ms.append(ms)
  for key in ('proj_rgb', 'proj_semantic', 'proj_depth', 'proj_mask'):
    if not torch.equal(getattr(out, key),
                       torch.cat([getattr(s, key) for s in singles])):
      raise AssertionError(f'predict_poses {key} != single calls')
  rgb_err = (out.pred_rgb.int() - torch.cat(
      [s.pred_rgb for s in singles]).int()).abs()
  depth_err = float((out.pred_depth - torch.cat(
      [s.pred_depth for s in singles])).abs().max())
  share = float((rgb_err > 0).float().mean())
  log(f'  (b) predict_poses K={POSES_K}: guidance torch.equal to {POSES_K} '
      f'single calls and to the plain splat (memory read at batch stride 0);'
      f' pred_rgb off by up to {int(rgb_err.max())} levels on {share:.4f} of '
      f'values, pred_depth by up to {depth_err:.4g} (band: '
      f'{POSES_RGB_LEVELS} levels on {POSES_RGB_SHARE}, {POSES_DEPTH_ATOL})')
  if (rgb_err.max() > POSES_RGB_LEVELS or share > POSES_RGB_SHARE
      or depth_err > POSES_DEPTH_ATOL):
    raise AssertionError('predict_poses outside the bf16 band')
  if not all(torch.equal(a, b) for a, b in zip(
      before, model.get_memory_state(copy=False)[:4])):
    raise AssertionError('predict_poses modified the memory')
  log(f'  (b) {poses_ms / POSES_K:.2f} ms per pose at K={POSES_K} '
      f'({poses_ms:.2f} ms the call) against '
      f'{statistics.median(single_ms):.2f} ms per __call__ (median of '
      f'{POSES_K}), each a replay of a graph captured without the checks; '
      f'the model\'s graph pool {pool / 2**30:.2f} GiB after the K={POSES_K} '
      f'capture; peak device memory over the replay {peak / 2**30:.2f} GiB '
      f'({(peak - base) / 2**30:.2f} GiB above what was allocated before '
      f'it) ({power})')
  return launches, check.max_err


def phase_perturbation(model, splat_cuda, geometry, power, depth):
  """(c) sample_perturbed_views, 16 views in chunks of 8."""
  from se3ds_torch.inference import perturbation
  start = np.zeros((1, 3), np.float32)
  set_launches()
  with CheckedStage(geometry) as check:
    views, ms = timed_call(check, lambda: perturbation.sample_perturbed_views(
        model, start, depth[0], PERTURBED_VIEWS, np.random.RandomState(0),
        chunk=POSES_K))
  launches = tracing.count(FAST)
  chunks = -(-len(views) // POSES_K)
  if (len(views) != PERTURBED_VIEWS or launches != 2 * chunks
      or not all(o.pred_rgb.shape == (1, H, W, 3) for _, o in views)):
    raise AssertionError(f'perturbation: {len(views)} views, {launches} '
                         'launches')
  log(f'  (c) sample_perturbed_views: {len(views)} views in {chunks} '
      f'predict_poses chunks of {POSES_K}, {ms / len(views):.2f} ms per view '
      f'({ms:.2f} ms in all, replays of (b)\'s graph with its in-graph '
      f'checks; {check.calls} splat stages == plain) ({power})')
  return launches, check.max_err


def phase_re10k(inference, model_config, splat_cuda, geometry, power):
  """(d) The RE10K path at full width."""
  cfg = dataclasses.replace(
      model_config.get_re10k_config(), ckpt_path=None, image_height=H,
      gen_dims=128, compute_dtype='bfloat16', splat_mode='fast',
      memory_frames=4)
  model = inference.SE3DSModel(
      cfg, device='cuda', generator=torch.Generator(device='cuda').manual_seed(
          1))
  rgb, depth = smooth_image(H, H, 3)
  fov = torch.tensor([0.8, 0.8])
  warps, warp_ms, warp_err = [], [0.0, 0.0], 0.0
  for source, pad in ((rgb, -1.0), (depth, 0.0)):
    src = torch.from_numpy(source)
    for call in range(2):  # the first call, then a warm one
      sync()
      t0 = time.perf_counter()
      got = geometry.project_perspective_image(src.cuda(), fov.cuda(), H,
                                               pad_value=pad)
      sync()
      warp_ms[call] += (time.perf_counter() - t0) * 1e3
    want = geometry.project_perspective_image(src, fov, H, pad_value=pad)
    warp_err = max(warp_err, float((got.cpu() - want).abs().max()))
    warps.append(got)
  if warp_err > WARP_ATOL:
    raise AssertionError(f'perspective warp card vs CPU {warp_err}')
  pano_rgb = torch.clamp(warps[0], 0, 255).int()[None]
  pano_depth = torch.clamp(warps[1][..., 0], 0, 1)[None]
  sem = torch.zeros((1, H, W, 1), dtype=torch.int32, device='cuda')
  set_launches()
  with CheckedStage(geometry) as check:
    _, add_ms = timed_call(check, lambda: model.add_to_memory(
        pano_rgb, sem, pano_depth, np.zeros((1, 3), np.float32),
        mask_blurred=False))
    steps = []
    for i in range(3):
      out, ms = timed_call(check, lambda: model(
          np.array([[0.1 * (i + 1), 0.05 * (i + 1), 0.0]], np.float32),
          add_preds_to_memory=True))
      steps.append(ms)
  launches = tracing.count(FAST)
  intrinsics = torch.diag(torch.tensor([float(H), float(H), 1.0],
                                       device='cuda'))
  view = lambda: geometry.get_perspective_from_equirectangular_image(
      out.pred_rgb[0].float(), intrinsics, torch.eye(3, device='cuda'), H, H)
  _, first_persp_ms = timed_call(check, view)
  persp, persp_ms = timed_call(check, view)
  coverage = float(out.proj_mask.mean())
  if (launches != 6 or persp.shape != (H, H, 3)
      or not torch.isfinite(persp).all() or not 0 < coverage < 1):
    raise AssertionError(f're10k: {launches} launches, {persp.shape}, '
                         f'coverage {coverage}')
  log(f'  (d) RE10K config (unmasked, uncompacted cloud): 512x512 source '
      f'warped to {H}x{W}, RGB + depth, in {warp_ms[0]:.2f} ms (first calls)'
      f' and {warp_ms[1]:.2f} ms (warm), card vs CPU max |d| '
      f'{warp_err:.3g} (atol {WARP_ATOL}); add_to_memory '
      f'(mask_blurred=False) {add_ms:.2f} ms, 3 feedback steps '
      f'{[round(m, 2) for m in steps]} ms (guidance coverage {coverage:.4f}, '
      f'splat stages == plain), {H}x{H} perspective view {first_persp_ms:.2f}'
      f' ms (first call), {persp_ms:.2f} ms (warm) ({power})')
  del model
  return launches, check.max_err


def phase_pointcloud(model, power, pano):
  """(e) write_memory_as_pointcloud after one frame."""
  import tempfile
  model.reset_memory()
  model.add_to_memory(*pano, np.zeros((1, 3), np.float32))
  sync()
  fd, path = tempfile.mkstemp(suffix='.ply', dir=BUILD_DIR)
  os.close(fd)
  try:
    t0 = time.perf_counter()
    model.write_memory_as_pointcloud(path)
    seconds = time.perf_counter() - t0
    size = os.path.getsize(path)
    with open(path, 'rb') as f:
      header = f.read(200).split(b'\n')
  finally:
    os.remove(path)
  points = int(header[2].split()[-1])
  if header[0] != b'ply' or points < 0.5 * H * W:
    raise AssertionError(f'.ply header {header[:3]}')
  log(f'  (e) write_memory_as_pointcloud after one frame: {points} points, '
      f'{size / 2**20:.1f} MiB in {seconds:.2f} s ({power})')


def phase_checkpoint(inference, model_config, splat_cuda, power, model_dir):
  """(f) Serving the EMA generator of phase 8's port-trained checkpoint."""
  from se3ds_torch.models import folding
  from se3ds_torch.models import generator as generator_lib
  from se3ds_torch.train import checkpoints
  cfg = model_config.SE3DSConfig(
      ckpt_path=model_dir, image_height=128, gen_dims=128,
      resnet_version='101', memory_frames=3, splat_mode='fast')
  torch.backends.cudnn.allow_tf32 = False
  sync()
  t0 = time.perf_counter()
  restored = inference.SE3DSModel(cfg, device='cuda')
  sync()
  restore_s = time.perf_counter() - t0
  manager = checkpoints.CheckpointManager(model_dir)
  bundle = torch.load(manager._path(manager.latest_step()), map_location='cpu',
                      weights_only=True, mmap=True)
  ema = generator_lib.ResNetGenerator(gen_dims=128, resnet_version='101',
                                      spectral_fold=False).cuda()
  ema.load_state_dict(bundle['ema_generator'])
  built = inference.SE3DSModel(dataclasses.replace(cfg, ckpt_path=None),
                               device='cuda')
  built.model.load_state_dict(folding.serving_state_dict(ema))
  del bundle, ema
  weights = [m.model.state_dict() for m in (restored, built)]
  if weights[0].keys() != weights[1].keys() or not all(
      torch.equal(weights[0][k], weights[1][k]) for k in weights[0]):
    raise AssertionError('checkpoint: restored weights != serving_state_dict')
  rgb, sem, depth = synthetic_pano(128, 4)
  outs = []
  # cuDNN's default transposed-convolution algorithms may sum in any
  # order; deterministic ones make two models' outputs comparable bit
  # for bit.
  torch.backends.cudnn.deterministic = True
  set_launches()
  try:
    for model in (restored, built):
      model.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32))
      step = model(np.array([[0.3, 0.1, 0.0]], np.float32),
                   add_preds_to_memory=True)
      traj = model.predict_trajectory(np.array([[0.5, 0.1, 0.0]],
                                               np.float32))
      outs.append([x for x in (*step, *traj) if x is not None])
  finally:
    torch.backends.cudnn.deterministic = False
  launches = tracing.count(FAST)
  if launches != 8 or not all(torch.equal(a, b) for a, b in zip(*outs)):
    raise AssertionError(f'checkpoint: {launches} launches, or the restored '
                         'model and the one built from serving_state_dict '
                         'disagree')
  log(f'  (f) SE3DSModel(ckpt_path=<phase 8 model_dir>) at image 128, '
      f'gen_dims 128, ResNet-101: restored the EMA generator of step '
      f'{manager.latest_step()} in {restore_s:.2f} s (model build included); '
      'weights, and outputs with cuDNN\'s deterministic algorithms, '
      'torch.equal to a model built from folding.serving_state_dict of the '
      f'same bundle ({power})')
  return launches


def phase_serving_api(inference, model_config, splat_cuda, geometry, power,
                      model_dir):
  log('== phase 9: the serving API at full width (1024x512, gen_dims 128, '
      'ResNet-101, bf16, fast, memory_frames 8) ==')
  pano = synthetic_pano(H, 0)
  launches, max_err = {}, 0.0
  model, launches['a'], err = phase_ring(inference, model_config, splat_cuda,
                                         geometry, power, pano)
  max_err = max(max_err, err)
  launches['b'], err = phase_poses(model, splat_cuda, geometry, power)
  max_err = max(max_err, err)
  launches['c'], err = phase_perturbation(model, splat_cuda, geometry, power,
                                          pano[2])
  max_err = max(max_err, err)
  launches['d'], err = phase_re10k(inference, model_config, splat_cuda,
                                   geometry, power)
  max_err = max(max_err, err)
  phase_pointcloud(model, power, pano)
  del model
  torch.cuda.empty_cache()
  launches['f'] = phase_checkpoint(inference, model_config, splat_cuda, power,
                                   model_dir)
  log(f'  splat_fast point passes launched by phase 9: {launches}')
  return sum(launches.values()), max_err


def phase_highres(power):
  log('== phase 10: full-width highres training (1024x512, gen_dims 128, '
      'ResNet-101, D dis_dims 128 n_dis 2 n_layers 6, float32) ==')
  torch.cuda.empty_cache()
  log(f'  device memory allocated before: '
      f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB')
  log(f'  (a) without remat, {HIGHRES_CHUNK} per chunk (the largest that '
      'fits):')
  watched_train(HIGHRES_GIN, HIGHRES_CHUNK, power)
  log(f'  (b) with remat, {HIGHRES_REMAT_CHUNK} per chunk (the recipe\'s '
      'share of one card):')
  watched_train(HIGHRES_GIN, HIGHRES_REMAT_CHUNK, power, remat=True)
  torch.backends.cudnn.allow_tf32 = False
  torch.cuda.empty_cache()


def phase_torchrun(power, cli_root):
  log('== phase 10f: highres through the CLI under torchrun '
      '--nproc_per_node 1 (remat, 8 a chunk, phase 8\'s records) ==')
  from se3ds_torch.train import checkpoints as ckpt_lib
  data = os.path.join(cli_root, 'data')
  model_dir = os.path.join(cli_root, 'highres')
  steps = CLI_TRAIN_FILES * CLI_RECORDS_PER_FILE // (2 * HIGHRES_REMAT_CHUNK)
  bindings = [
      f"R2RImageDataset.data_dir = '{data}/'",
      f"R2RVideoDataset.data_dir = '{data}/'", 'GAN.num_epochs = 1',
      f"R2RImageDataset.num_examples_override = {{'train': "
      f"{CLI_TRAIN_FILES * CLI_RECORDS_PER_FILE}, 'val': 8}}",
      f'GAN.train_batch_size = {HIGHRES_REMAT_CHUNK}', 'GAN.remat = True',
      'GAN.num_batched_steps = 1', 'GAN.log_every_steps = 1',
      f'GAN.save_every_steps = {steps}']
  argv = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
          '--nproc_per_node', '1', '-m', 'se3ds_torch.main', '--mode', 'TRAIN',
          '--model_dir', model_dir, '--gin_config', HIGHRES_GIN]
  for binding in bindings:
    argv += ['--gin_bindings', binding]
  train_log = os.path.join(cli_root, 'torchrun.log')
  t0 = time.perf_counter()
  with open(train_log, 'w') as out:
    proc = subprocess.run(argv, cwd=REPO, stdout=out,
                          stderr=subprocess.STDOUT, timeout=900, check=False)
  train_s = time.perf_counter() - t0
  with open(train_log) as f:
    lines = f.readlines()
  if proc.returncode:
    log(''.join(lines[-40:]))
    raise AssertionError(f'torchrun ... se3ds_torch.main exited '
                         f'{proc.returncode}')
  scalars = event_scalars(model_dir)
  bad = [(step, tag) for step, tag, v in scalars if not np.isfinite(v)]
  rates = [(step, v) for step, tag, v in scalars if tag == 'steps_per_sec']
  saved = ckpt_lib.CheckpointManager(model_dir).all_steps()
  if bad or len(rates) != steps or saved != [steps] or (
      not ckpt_lib.is_training_done(model_dir)):
    log(''.join(lines[-40:]))
    raise AssertionError(f'{len(rates)} steps logged, non-finite {bad}, '
                         f'checkpoints {saved}')
  world = [line.strip() for line in lines if 'TRAIN on' in line]
  if not world or not world[-1].endswith('rank 0 of 1'):
    raise AssertionError(f'not a torchrun rank: {world}')
  log(f'  {world[-1]}; {train_s:.2f} s wall; '
      'steps/sec as logged: ' + ', '.join(
          f'step {s} {v:.4f} ({1e3 / v:.1f} ms)' for s, v in rates)
      + f'; checkpoint at step {saved[0]}, TRAIN_DONE ({power})')


def float64_state(trainer):
  """`trainer.create_state()` in float64 (the same seeded weights)."""
  from se3ds_torch.models import folding
  from se3ds_torch.train import state as state_lib
  generator, discriminator = (m.to(trainer.device)
                              for m in trainer._build_models())
  rng = torch.Generator(device=trainer.device).manual_seed(trainer.seed)
  folding.init_random_(generator, rng)
  folding.init_random_(discriminator, rng)
  generator.double().dtype = torch.float64
  return state_lib.create_train_state(
      generator, discriminator.double(), trainer.g_lr, trainer.d_lr,
      trainer.beta1, trainer.beta2, trainer.data)


# (e): float64, the tolerances of tests/test_torch_distributed.py: the
# group's path (BatchNorm over summed statistics, Flax's E[x^2] - E[x]^2)
# and the plain one differ by what stays float32 in both (the clip's
# norms, the plain BatchNorm's running statistics).
GROUP_TOLERANCES = {'params': 1e-8, 'stats': 1e-7, 'u': 1e-9,
                    'exp_avg': 1e-6, 'exp_avg_sq': 1e-6, 'adam_steps': 0.0}


def phase_remat_and_group():
  log('== phase 10 (d, e): the tiny trainer: remat against no remat, a '
      'world-1 NCCL group against none ==')
  import tempfile
  import torch.distributed as dist
  from se3ds_torch.models import layers
  from se3ds_torch.train import checkpoints as ckpt_lib
  from se3ds_torch.train import state as state_lib
  from se3ds_torch.train import trainer as trainer_lib
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cudnn.deterministic = True
  torch.backends.cudnn.benchmark = False
  os.makedirs(BUILD_DIR, exist_ok=True)
  root = tempfile.mkdtemp(prefix='train_dp_', dir=BUILD_DIR)
  try:
    # (d) Two steps (the EMA assign, then a decay) each way from one state.
    trainer = tiny_trainer('cuda', os.path.join(root, 'remat'))
    batches = [trainer.device_batch(b) for b, _ in zip(
        trainer_lib.synthetic_batches(4, 32, 5), range(2))]
    runs = []
    for remat in (False, True):
      state = trainer.create_state()
      start = copy.deepcopy(ckpt_lib.state_bundle(state))
      hp = trainer.hp._replace(remat=remat, num_batched_steps=1)
      metrics = [state_lib.train_step(state, b, hp) for b in batches]
      runs.append((start, state, metrics))
    (start, plain, m_plain), (start_r, remat, m_remat) = runs
    same = (ckpt_lib.bundles_equal(start, start_r)
            and all(torch.equal(a[k], b[k]) for a, b in zip(m_plain, m_remat)
                    for k in a)
            and ckpt_lib.bundles_equal(ckpt_lib.state_bundle(plain),
                                       ckpt_lib.state_bundle(remat)))
    if not same:
      log('  remat differs: ' + ', '.join(
          f'{k} {v:.3g}' for k, v in sorted(
              state_lib.state_differences(remat, plain).items())))
      raise AssertionError('remat and stored activations differ on the card')
    after = ckpt_lib.state_bundle(remat)
    stale = [f'{part}.{k}' for part in ('generator', 'discriminator',
                                        'ema_generator')
             for k, v in start[part].items()
             if k.endswith(('.u', 'running_mean', 'running_var'))
             and torch.equal(v, after[part][k])]
    if stale:
      raise AssertionError(f'state that did not advance: {stale[:5]}')
    log('  (d) 2 steps with remat: metrics, G, D, the EMA and both Adam '
        'states torch.equal to the steps storing activations (cuDNN '
        'deterministic); every u and BatchNorm statistic advanced')

    # (e) The data-parallel path at world 1 on NCCL, in float64.
    batch = {k: v.double() for k, v in trainer.device_batch(
        next(trainer_lib.synthetic_batches(4, 32, 6))).items()}
    alone = float64_state(trainer)
    m_alone = state_lib.train_step(alone, batch, trainer.hp)
    synced = []
    norm = layers.SyncBatchNorm._global_batch_norm

    def counted(module, x):
      synced.append(1)
      return norm(module, x)

    dist.init_process_group('nccl', init_method=f'file://{root}/rendezvous',
                            world_size=1, rank=0)
    layers.SyncBatchNorm._global_batch_norm = counted
    try:
      grouped = tiny_trainer('cuda', os.path.join(root, 'group'))
      if (grouped.data.world_size, dist.get_backend()) != (1, 'nccl'):
        raise AssertionError(f'{grouped.data}, {dist.get_backend()}')
      state = float64_state(grouped)
      m_group = state_lib.train_step(state, batch, grouped.hp)
      manager = ckpt_lib.CheckpointManager(grouped.model_dir)
      manager.save(state.step, state)
    finally:
      layers.SyncBatchNorm._global_batch_norm = norm
      dist.destroy_process_group()
    restored = float64_state(tiny_trainer('cuda', os.path.join(root, 'x')))
    manager.restore(restored)
    rel = {k: abs(float(m_group[k]) - float(m_alone[k]))
           / max(abs(float(m_alone[k])), 1e-6) for k in m_alone}
    diffs = state_lib.state_differences(restored, alone)
    log(f'  (e) world-1 NCCL group ({len(synced)} synced BatchNorm calls), '
        f'its checkpoint restored without a group, against no group: '
        f'metrics rel {max(rel.values()):.3g}; ' + ', '.join(
            f'{k} {v:.3g}' for k, v in sorted(diffs.items())))
    over = [k for k, v in rel.items() if v > 1e-6] + [
        k for k, v in diffs.items()
        if v > GROUP_TOLERANCES.get(k.split('_', 1)[-1], float('inf'))]
    if over or not synced:
      raise AssertionError(f'the NCCL path disagrees: {over}')
    log(f'  within {GROUP_TOLERANCES}, metrics rtol 1e-6')
  finally:
    torch.backends.cudnn.deterministic = False
    shutil.rmtree(root)


# -- phase 11: every splat mode, the mesh, Trainer.test under torchrun ------

MODES_11A = ('fast_exact', 'sorted', 'sorted_packed', 'dual_sorted')
MESH_MODES = ('fast', 'fast_exact', 'scatter', 'pallas')
MODE_STEPS = 3
MESH_TRAJECTORY = np.array([[0.25, 0.1, 0.0], [0.5, 0.1, 0.0],
                            [0.75, 0.15, 0.0]], np.float32)
# Trainer.test's scores under torchrun against phase 8's: the CPU test's
# tolerances (tests/test_torch_mesh_serving.py).
TEST_FID_RTOL, TEST_SCORE_RTOL = 1e-4, 1e-5


def cpu_guidance(mode, memory, position, depth_scale=DEPTH_SCALE):
  """`memory_project`'s four outputs for `mode`, computed on the CPU from
  the view coordinates that the card computes on this memory: the card's
  `equirect_view_coords(xyz - offset)`, copied to the host, through the
  mode's function (the exact splat's plain version for 'sorted')."""
  from se3ds_torch import constants
  from se3ds_torch.models import inference
  from se3ds_torch.ops import geometry
  from se3ds_torch.ops import splat
  offset = inference._transform_position(position.to(torch.float32))
  view = lambda xyz: geometry.equirect_view_coords(xyz - offset[..., None])
  voids = (float(constants.INVALID_SEM_VALUE),
           float(constants.INVALID_RGB_VALUE))
  if mode == 'dual_sorted':
    depth, sem, rgb = splat.project_dual_sorted_packed(
        view(memory.coords).cpu(), memory.feats.cpu(),
        view(memory.rgb_coords).cpu(), memory.rgb.cpu(), H, W, depth_scale,
        *voids)
  else:
    fn = {'sorted': splat.project_to_feat_plain,
          'fast_exact': splat.project_to_feat_fast_exact,
          'sorted_packed': splat.project_to_feat_sorted_packed}[mode]
    _, sem = fn(view(memory.coords).cpu(), memory.feats.cpu(), H, W,
                depth_scale, voids[0])
    depth, rgb = fn(view(memory.rgb_coords).cpu(), memory.rgb.cpu(), H, W,
                    depth_scale, voids[1])
  return sem, depth, rgb, inference._proj_mask(depth, rgb)


def phase_modes(inference, model_config, splat_cuda, power):
  """11a: 'fast_exact', 'sorted', 'sorted_packed' and 'dual_sorted'
  through SE3DSModel on phase 4's config, 3 feedback steps each (one
  model, its splat mode switched between runs); every splat stage held
  against the same function on the CPU, and the byte-exact modes
  against the exact kernel's guidance; then the stage's device ms per
  served frame for every mode on one memory."""
  log('== phase 11a: the splat modes through SE3DSModel at full width '
      '(1024x512, gen_dims 128, ResNet-101, bf16) ==')
  model = inference.SE3DSModel(
      serving_config(model_config), device='cuda',
      generator=torch.Generator(device='cuda').manual_seed(0))
  pano = synthetic_pano(H, 0)
  real = inference.memory_project
  seen = {'calls': 0, 'max_err': 0.0, 'check_s': 0.0}

  def checked(memory, position, height, width, depth_scale,
              splat_mode='fast', **kwargs):
    out = real(memory, position, height, width, depth_scale,
               splat_mode=splat_mode, **kwargs)
    sync()
    t0 = time.perf_counter()
    counts = tracing.count(FAST), tracing.count(EXACT)
    want = cpu_guidance(splat_mode, memory, position, depth_scale)
    seen['max_err'] = max(seen['max_err'], equal_or_raise(
        f'{splat_mode} guidance, card vs CPU', [o.cpu() for o in out], want))
    if splat_mode != 'fast_exact':  # byte features: the exact splat's
      equal_or_raise(f'{splat_mode} guidance vs the exact kernel', out,
                     real(memory, position, height, width, depth_scale,
                          splat_mode='scatter', **kwargs))
    set_launches(*counts)
    seen['calls'] += 1
    seen['check_s'] += time.perf_counter() - t0
    return out

  launches = {'fast': 0, 'exact': 0}
  inference.memory_project = checked
  try:
    for mode in MODES_11A:
      model.config = dataclasses.replace(model.config, splat_mode=mode)
      model.reset_memory()
      model.add_to_memory(*pano, np.zeros((1, 3), np.float32))
      step_ms = []
      set_launches()
      for i in range(MODE_STEPS):
        sync()
        before, t0 = seen['check_s'], time.perf_counter()
        out = model(np.array([[0.25 * (i + 1), 0.1, 0.0]], np.float32),
                    add_preds_to_memory=True)
        sync()
        step_ms.append((time.perf_counter() - t0 - seen['check_s']
                        + before) * 1e3)
      fast, exact = tracing.count(FAST), tracing.count(EXACT)
      want_exact = 2 * MODE_STEPS if mode == 'sorted' else 0
      if fast or exact != want_exact:
        raise AssertionError(f'{mode}: {fast} fast and {exact} exact '
                             f'launches (expected 0 and {want_exact})')
      launches['exact'] += exact
      if not torch.isfinite(out.pred_depth).all():
        raise AssertionError(f'{mode}: non-finite pred_depth')
      log(f'  {mode}: {MODE_STEPS} steps, guidance torch.equal to the CPU '
          f'run on the same view coordinates'
          + ('' if mode == 'fast_exact' else ' and to the exact kernel')
          + f'; ms per step (checks excluded) '
          + ', '.join(f'{t:.2f}' for t in step_ms)
          + f'; exact launches {exact} ({power})')
  finally:
    inference.memory_project = real
  if seen['calls'] != len(MODES_11A) * MODE_STEPS:
    raise AssertionError(f'{seen["calls"]} splat stages checked')

  # The stage per served frame, every mode on the last run's memory.
  memory = model._live_memory(model.get_memory_state(copy=False),
                              model._frames_written,
                              model._sem_frames_live())
  position = torch.tensor([[0.5, 0.0, 0.0]], device='cuda')
  counts = tracing.count(FAST), tracing.count(EXACT)
  stage_ms = {mode: device_ms(lambda mode=mode: real(
      memory, position, H, W, DEPTH_SCALE, splat_mode=mode))
              for mode in ('fast', 'scatter') + MODES_11A}
  set_launches(*counts)
  log(f'  splat stage per served frame ({memory.coords.shape[-1]} semantic + '
      f'{memory.rgb_coords.shape[-1]} RGB points), device ms: ' + ', '.join(
          f'{k} {v:.4f}' for k, v in stage_ms.items()) + f' ({power})')
  del model
  torch.cuda.empty_cache()
  return launches, seen['max_err'], stage_ms


def phase_mesh(inference, model_config, splat_cuda, geometry, power):
  """11b: SE3DSModel(mesh=create_mesh(1, 1)) on a world-1 NCCL group
  against the meshless model on the same weights, for 'fast',
  'fast_exact', 'scatter' and 'pallas' (which becomes 'fast'): a 3-step
  predict_trajectory and predict_poses at K = 8, every output torch.equal
  (cuDNN deterministic); the split exact passes against the cooperative
  launch; 11c: 'fast' with 5 channels against the exact kernel."""
  log('== phase 11b: SE3DSModel(mesh=create_mesh(1, 1)) on a world-1 NCCL '
      'group against the meshless model, phase 4\'s config ==')
  import tempfile
  import torch.distributed as dist
  from se3ds_torch.parallel import mesh as mesh_lib
  from se3ds_torch.parallel import splat_shard
  from se3ds_torch.ops import splat
  os.makedirs(BUILD_DIR, exist_ok=True)
  root = tempfile.mkdtemp(prefix='mesh_', dir=BUILD_DIR)
  torch.backends.cudnn.deterministic = True
  pano = synthetic_pano(H, 0)
  poses = np.random.RandomState(5).uniform(-0.8, 0.8, (POSES_K, 3)).astype(
      np.float32) * np.array([1, 1, 0.1], np.float32)
  launches = {'fast': 0, 'exact': 0}
  max_err = 0.0
  mesh_stage_ms = {}
  dist.init_process_group('nccl', init_method=f'file://{root}/rendezvous',
                          world_size=1, rank=0)
  try:
    mesh = mesh_lib.create_mesh(1, 1)
    position = torch.tensor([[0.5, 0.0, 0.0]], device='cuda')
    for mode in MESH_MODES:
      runs, stage_ms = {}, {}
      for name, kwargs in (('alone', {}), ('mesh', {'mesh': mesh})):
        model = inference.SE3DSModel(
            serving_config(model_config, splat_mode=mode), device='cuda',
            generator=torch.Generator(device='cuda').manual_seed(0),
            **kwargs)
        if mode == MESH_MODES[0]:
          log(f'  {name}: ' + (f'runs eagerly ({model.uncaptured})'
                               if model.uncaptured else 'replays graphs'))
        model.add_to_memory(*pano, np.zeros((1, 3), np.float32))
        # Warm-up at batch 8 and 1 (cuDNN's set-up); no memory write.
        model.predict_poses(poses)
        model(MESH_TRAJECTORY[:1])
        set_launches()
        sync()
        t0 = time.perf_counter()
        traj = model.predict_trajectory(MESH_TRAJECTORY)
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3 / len(MESH_TRAJECTORY)
        out = model.predict_poses(poses)
        sync()
        runs[name] = (traj, out, step_ms, model.config.splat_mode,
                      tracing.count(FAST), tracing.count(EXACT))
        launches['fast'] += tracing.count(FAST)
        launches['exact'] += tracing.count(EXACT)
        live = model._live_memory(model.get_memory_state(copy=False),
                                  model._frames_written,
                                  model._sem_frames_live())
        # The splat stage of a served frame on this model's memory, with
        # or without the mesh: what the mesh costs on the card.
        counts = tracing.count(FAST), tracing.count(EXACT)
        stage_ms[name] = device_ms(lambda: inference.memory_project(
            live, position, H, W, DEPTH_SCALE,
            splat_mode=model.config.splat_mode,
            mesh=kwargs.get('mesh')))
        set_launches(*counts)
        if mode == 'scatter' and name == 'mesh':
          memory = live
        del model
      (traj, out, alone_ms, alone_mode, alone_fast, alone_exact) = (
          runs['alone'])
      (mtraj, mout, mesh_ms, mesh_mode, mesh_fast, mesh_exact) = runs['mesh']
      resolved = {'pallas': 'fast'}.get(mode, mode)
      splats = 2 * (len(MESH_TRAJECTORY) + 1)  # 2 clouds per forward
      want = {'fast': (splats, 0, splats, 0), 'fast_exact': (0, 0, 0, 0),
              'scatter': (0, splats, 0, 2 * splats)}[resolved]
      got = (alone_fast, alone_exact, mesh_fast, mesh_exact)
      if mesh_mode != resolved or got != want:
        raise AssertionError(f'{mode}: mesh mode {mesh_mode}, launches '
                             f'(fast, exact; alone then mesh) {got}, '
                             f'expected {want}')
      for a, b, what in ((traj, mtraj, 'trajectory'), (out, mout, 'poses')):
        for field in a._fields:
          if getattr(a, field) is not None:
            max_err = max(max_err, equal_or_raise(
                f'{mode} {what} {field}, mesh vs none', [getattr(b, field)],
                [getattr(a, field)]))
      log(f'  {mode} (the mesh model runs {mesh_mode!r}): trajectory of '
          f'{len(MESH_TRAJECTORY)} and predict_poses K={POSES_K} torch.equal'
          f' to the meshless model; ms per step (host clock) {alone_ms:.2f}'
          f' without the mesh, {mesh_ms:.2f} with it; splat stage per '
          f'served frame (device) {stage_ms["alone"]:.4f} ms without, '
          f'{stage_ms["mesh"]:.4f} ms with; launches (fast, exact) '
          f'{(alone_fast, alone_exact)} without, {(mesh_fast, mesh_exact)} '
          f'with ({power})')
      mesh_stage_ms[mode] = (
          stage_ms['alone'], stage_ms['mesh'])

    # The split exact passes against the one cooperative launch, on the
    # mesh 'scatter' model's memory; these launches are comparisons.
    counts = tracing.count(FAST), tracing.count(EXACT)
    group = mesh.get_group('data')
    offset = torch.tensor([[0.5, 0.0, 0.0, 0.0]], device='cuda')
    from se3ds_torch import constants
    clouds = (('semantic', memory.coords, memory.feats,
               float(constants.INVALID_SEM_VALUE), False),
              ('rgb', memory.rgb_coords, memory.rgb,
               float(constants.INVALID_RGB_VALUE), True))
    split_ms = {'pass 1': 0.0, 'pass 2': 0.0, 'cooperative stage': 0.0,
                'split stage': 0.0, 'split stage again': 0.0,
                'cooperative stage again': 0.0}
    for name, xyz, feats, void, need_depth in clouds:
      args = (xyz, feats, H, W, DEPTH_SCALE, void)
      coop = splat_cuda.exact_words(*args, offset=offset)
      words = splat_cuda.exact_pass(*args, 1, offset=offset)
      words[..., 0] = splat_cuda.all_reduce_unsigned_min(
          words[..., 0].contiguous(), group)
      words = splat_cuda.exact_pass(*args, 2, words=words, offset=offset)
      equal_or_raise(f'{name} split exact passes vs the cooperative launch',
                     [words], [coop])
      sharded = lambda: splat_shard.project_memory_equirect_sharded(
          feats, xyz, offset, H, W, void, DEPTH_SCALE, group=group,
          splat_mode='scatter', need_depth=need_depth)
      whole = lambda: geometry.project_memory_equirect(
          feats, xyz, offset, H, W, void, DEPTH_SCALE, 'scatter',
          need_depth=need_depth)
      max_err = max(max_err, equal_or_raise(
          f'{name} sharded exact stage vs unsharded', sharded(), whole()))
      split_ms['pass 1'] += device_ms(
          lambda: splat_cuda.exact_pass(*args, 1, offset=offset))
      split_ms['pass 2'] += device_ms(
          lambda: splat_cuda.exact_pass(*args, 2, words=words.clone(),
                                        offset=offset))
      # In turns: cooperative, split, split, cooperative.
      for key, fn in (('cooperative stage', whole), ('split stage', sharded),
                      ('split stage again', sharded),
                      ('cooperative stage again', whole)):
        split_ms[key] += device_ms(fn)
    log('  split exact passes torch.equal to the cooperative launch (words) '
        'and the sharded exact stage to the unsharded one, per served frame '
        '(semantic + RGB), device ms: ' + ', '.join(
            f'{k} {v:.4f}' for k, v in split_ms.items())
        + ' (pass 2 includes a copy of the words; the split stage its two '
        f'world-1 all_reduces) ({power})')
    split_ms['mesh stage'] = mesh_stage_ms

    log('== phase 11c: \'fast\' with 5 feature channels on the card is the '
        'exact kernel ==')
    xyz, feats = memory.rgb_coords, memory.rgb
    feats5 = torch.cat([feats, feats[..., :2]], dim=-1)
    void = float(constants.INVALID_RGB_VALUE)
    fast5 = geometry.project_memory_equirect(feats5, xyz, offset, H, W, void,
                                             DEPTH_SCALE, 'fast')
    exact5 = splat.splat_images(True, xyz, feats5, H, W, DEPTH_SCALE, void,
                                offset=offset)
    max_err = max(max_err, equal_or_raise("'fast' C=5 vs the exact kernel",
                                          fast5, exact5))
    log(f'  {xyz.shape[-1]} points, C=5: torch.equal')
    set_launches(*counts)
  finally:
    torch.backends.cudnn.deterministic = False
    dist.destroy_process_group()
    shutil.rmtree(root)
    torch.cuda.empty_cache()
  return launches, max_err, split_ms


def phase_test_torchrun(power, model_dir, cli_root):
  """11d: `Trainer.test` through `torchrun --standalone --nproc_per_node
  1 -m se3ds_torch.main --mode TEST` on phase 8's records and step-4
  checkpoint (a fresh model_dir linking it), its scores against phase
  8's world-1 TEST scores."""
  log('== phase 11d: Trainer.test under torchrun --nproc_per_node 1 on '
      'phase 8\'s checkpoint, against phase 8\'s scores ==')
  import glob
  test_dir = os.path.join(cli_root, 'test_torchrun')
  os.makedirs(test_dir)
  os.symlink(os.path.join(model_dir, str(CLI_STEPS)),
             os.path.join(test_dir, str(CLI_STEPS)))
  for path in glob.glob(os.path.join(model_dir, '*')):
    if os.path.isfile(path) and not os.path.basename(path).startswith(
        ('events', 'scores')):
      shutil.copy(path, test_dir)  # TRAIN_DONE, the operative configs
  argv = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
          '--nproc_per_node', '1', '-m', 'se3ds_torch.main', '--mode', 'TEST',
          *cli_argv(os.path.join(cli_root, 'data'), test_dir)]
  test_log = os.path.join(cli_root, 'torchrun_test.log')
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  with open(test_log, 'w') as out:
    proc = subprocess.run(argv, cwd=REPO, stdout=out,
                          stderr=subprocess.STDOUT, timeout=600, check=False)
  test_s = time.perf_counter() - t0
  with open(test_log) as f:
    lines = f.readlines()
  if proc.returncode:
    log(''.join(lines[-40:]))
    raise AssertionError(f'torchrun ... --mode TEST exited {proc.returncode}')
  world = [line.strip() for line in lines if 'TEST on' in line]
  if not world or not world[-1].endswith('rank 0 of 1'):
    raise AssertionError(f'not a torchrun rank: {world}')
  scores = lambda d: {tag: v for step, tag, v in event_scalars(d)
                      if step == CLI_STEPS and 'eval_image' in tag}
  want, got = scores(model_dir), scores(test_dir)
  if not want or got.keys() != want.keys():
    raise AssertionError(f'scores {sorted(got)} against {sorted(want)}')
  for tag, value in want.items():
    rtol = TEST_FID_RTOL if 'fid' in tag else TEST_SCORE_RTOL
    if not abs(got[tag] - value) <= rtol * abs(value):
      raise AssertionError(f'{tag}: {got[tag]} under torchrun, {value} in '
                           f'phase 8 (rtol {rtol})')
  rel = max(abs(got[t] - v) / max(abs(v), 1e-12) for t, v in want.items())
  log(f'  {world[-1]}; {test_s:.2f} s wall; {len(want)} scores equal phase '
      f'8\'s within FID rtol {TEST_FID_RTOL}, others {TEST_SCORE_RTOL} '
      f'(largest relative difference {rel:.3g}): ' + ', '.join(
          f'{t.split("/")[-1]} {got[t]:.6g}' for t in sorted(got))
      + f' ({power})')


RELEASE_STEPS = 2
MATH_SIZES = {'iou': (2, 8, 128, 256, 42), 'inpaint': (2, 48, 96)}
# The card's and the CPU's exp and log differ by ULPs.
KL_RTOL, KL_ATOL = 1e-5, 1e-6
MEAN_RTOL = 1e-6  # a mean of exact per-frame ratios, summed in another order


def release_bundle_arrays(generator):
  """{TF key: numpy array} of a trainable generator under the released
  checkpoints' key names (`tf_import.torch_path_to_tf_prefix`), in Keras
  layouts: HWIO kernels (HWOI for a transposed conv), BatchNorm
  gamma/beta/moving_mean/moving_variance, `spectral_conv_<k>_u`, and the
  int64 save_counter. The inverse of `tf_import.convert_tf_checkpoint`."""
  from se3ds_torch.models import layers
  from se3ds_torch.train import tf_import
  attr = tf_import.ATTR_SUFFIX
  modules = dict(generator.named_modules())
  bn_leaves = {'weight': 'gamma', 'bias': 'beta',
               'running_mean': 'moving_mean',
               'running_var': 'moving_variance'}
  out = {}
  for k, (name, tensor) in enumerate(generator.state_dict().items()):
    module, leaf = name.rsplit('.', 1)
    prefix = f'ema_generator/{tf_import.torch_path_to_tf_prefix(module)}'
    value = tensor.numpy()
    if leaf == 'u':
      leaf = f'spectral_conv_{k}_u'
    elif isinstance(modules[module], layers.SyncBatchNorm):
      leaf = bn_leaves[leaf]
    elif leaf == 'weight':
      leaf, value = 'kernel', value.transpose(2, 3, 1, 0)
    out[f'{prefix}/{leaf}{attr}'] = value
  out['save_counter' + attr] = np.int64(1)
  return out


def run_sampling_rss(argv, timeout):
  """Runs argv from the repo; returns (exit code, its output, its peak
  resident bytes sampled from /proc/<pid>/statm every 20 ms). A spawned
  process's ru_maxrss holds its parent's peak, and this machine's /proc
  has no VmHWM."""
  import tempfile
  page = os.sysconf('SC_PAGE_SIZE')
  peak = 0
  with tempfile.TemporaryFile('w+') as out:
    proc = subprocess.Popen(argv, cwd=REPO, stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    deadline = time.perf_counter() + timeout
    try:
      while proc.poll() is None:
        try:
          with open(f'/proc/{proc.pid}/statm') as f:
            peak = max(peak, int(f.read().split()[1]) * page)
        except (OSError, IndexError, ValueError):
          pass  # the process is exiting
        if time.perf_counter() > deadline:
          raise TimeoutError(f'{argv} ran over {timeout} s')
        time.sleep(0.02)
    finally:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    out.seek(0)
    return proc.returncode, out.read(), peak


def phase_release_checkpoint(inference, model_config, splat_cuda, power):
  """12 (a)-(c): a release-format checkpoint through the converter CLI,
  served at full width."""
  from se3ds_torch.models import folding
  from se3ds_torch.models import generator as generator_lib
  from se3ds_torch.train import checkpoints
  from se3ds_torch.train import tf_bundle
  import tempfile
  log('== phase 12: a release-format TF checkpoint at full width (gen_dims '
      '128, ResNet-101, 1024x512, bf16) ==')
  os.makedirs(BUILD_DIR, exist_ok=True)
  root = tempfile.mkdtemp(prefix='release_', dir=BUILD_DIR)
  try:
    # (a) Seeded weights; every 1-D tensor (BatchNorm statistics and
    # shifts, conv biases) drawn too, so no two layers hold equal values.
    t0 = time.perf_counter()
    with torch.device('cuda'):
      source = generator_lib.ResNetGenerator(
          gen_dims=128, resnet_version='101', spectral_fold=False)
    gen = torch.Generator(device='cuda').manual_seed(12)
    folding.init_random_(source, gen)
    with torch.no_grad():
      for tensor in source.state_dict().values():
        if tensor.dim() == 1:
          tensor.uniform_(0.5, 1.5, generator=gen)
    source = source.cpu()
    arrays = release_bundle_arrays(source)
    n_values = sum(v.size for v in arrays.values())
    gb = sum(v.nbytes for v in arrays.values()) / 1e9
    prefix = os.path.join(root, 'ckpt-1')
    t1 = time.perf_counter()
    tf_bundle.write_bundle(prefix, arrays)
    write_s = time.perf_counter() - t1
    del arrays
    with open(os.path.join(root, 'checkpoint'), 'w') as f:
      f.write('model_checkpoint_path: "ckpt-1"\n'
              'all_model_checkpoint_paths: "ckpt-1"\n')
    index_kb = os.path.getsize(prefix + '.index') / 1e3
    log(f'  (a) the ema_generator as a release bundle: '
        f'{len(source.state_dict())} tensors + save_counter, {n_values:,} values, {gb:.3f} GB, index '
        f'{index_kb:.1f} kB; write_bundle {write_s:.2f} s '
        f'({gb / write_s:.3f} GB/s), {time.perf_counter() - t0:.2f} s in all')

    # (b) The user command, in its own process (a host job: no card).
    served = os.path.join(root, 'converted.pt')
    t0 = time.perf_counter()
    code, output, peak = run_sampling_rss(
        [sys.executable, '-m', 'se3ds_torch.convert_tf_checkpoint',
         '--tf_ckpt', root, '--output', served], timeout=600)
    convert_s = time.perf_counter() - t0
    if code != 0:
      raise AssertionError(f'convert_tf_checkpoint failed:\n{output[-4000:]}')
    for line in output.splitlines():
      log(f'  (b) {line}')
    log(f'  (b) python -m se3ds_torch.convert_tf_checkpoint: {convert_s:.2f} s'
        f' wall (interpreter start included), peak RSS {peak / 1e9:.2f} GB '
        f'(sampled from /proc/<pid>/statm every 20 ms), {power}')

    # (c) Served in bf16 from the converted file and from the source's own
    # serving file.
    reference = os.path.join(root, 'source.pt')
    checkpoints.save_ema_generator(reference, source)
    del source
    models = []
    for path in (served, reference):
      t0 = time.perf_counter()
      models.append(inference.SE3DSModel(
          serving_config(model_config, ckpt_path=path), device='cuda'))
      sync()
      log(f'  (c) SE3DSModel(ckpt_path={os.path.basename(path)}) in '
          f'{time.perf_counter() - t0:.2f} s')
    weights = [m.model.state_dict() for m in models]
    if weights[0].keys() != weights[1].keys() or not all(
        torch.equal(weights[0][k], weights[1][k]) for k in weights[0]):
      raise AssertionError('release checkpoint: the converted weights != the '
                           'source\'s')
    del weights
    rgb, sem, depth = synthetic_pano(H, 12)
    outs = []
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    set_launches()
    try:
      for model in models:
        model.add_to_memory(rgb, sem, depth, np.zeros((1, 3), np.float32),
                            mask_blurred=True)
        frames = []
        for i in range(RELEASE_STEPS):
          step = model(np.array([[0.25 * (i + 1), 0.1, 0.0]], np.float32),
                       add_preds_to_memory=True)
          frames += [x for x in step if x is not None]
        outs.append(frames)
      sync()
    finally:
      torch.backends.cudnn.deterministic = deterministic
      torch.backends.cudnn.benchmark = benchmark
    launches = tracing.count(FAST)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(*outs) if a.numel())
    if launches != 2 * RELEASE_STEPS * len(models) or not all(
        torch.equal(a, b) for a, b in zip(*outs)):
      raise AssertionError(f'release checkpoint: {launches} launches, or the '
                           f'outputs differ (max |d| {err})')
    log(f'  (c) the state dicts torch.equal; add_to_memory + {RELEASE_STEPS} '
        f'feedback steps from each, every output torch.equal (max |d| {err}'
        f', cuDNN deterministic), {launches} \'fast\' point passes')
    return launches
  finally:
    shutil.rmtree(root)


def phase_math_utils(power):
  """12 (d): utils/math_utils on the card against the CPU."""
  import importlib.util
  from se3ds_torch.utils import math_utils
  n, t, h, w, c = MATH_SIZES['iou']
  g = torch.Generator().manual_seed(13)
  labels = torch.randint(0, c, (n, t, h, w), generator=g)
  truth = torch.where(torch.rand(n, t, h, w, generator=g) > 0.3, labels,
                      torch.randint(0, c, (n, t, h, w), generator=g))
  pred_1h = torch.nn.functional.one_hot(labels, c).float()
  true_1h = torch.nn.functional.one_hot(truth, c).float()
  mask = (torch.rand(n, t, generator=g) > 0.2).float()
  spatial = (torch.rand(n, t, h, w, generator=g) > 0.1).float()
  mu = torch.randn(4, h * w, generator=g)
  logvar = torch.randn(4, h * w, generator=g)
  mu2 = torch.randn(4, h * w, generator=g)
  logvar2 = torch.randn(4, h * w, generator=g)
  b, ih, iw = MATH_SIZES['inpaint']
  image = torch.where(torch.rand(b, ih, iw, generator=g) > 0.95,
                      torch.randint(1, 41, (b, ih, iw), generator=g), 0)
  cases = {
      'compute_sequence_iou': (math_utils.compute_sequence_iou,
                               (pred_1h, true_1h, mask, spatial)),
      'compute_sequence_accuracy': (math_utils.compute_sequence_accuracy,
                                    (labels, truth, mask, spatial)),
      'compute_kl': (math_utils.compute_kl, (mu, logvar, mu2, logvar2)),
      'nearest_neighbor_inpaint': (math_utils.nearest_neighbor_inpaint,
                                   (image,)),
  }
  for name, (fn, args) in cases.items():
    cpu = fn(*args)
    cuda = fn(*[a.cuda() for a in args])
    sync()
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    cuda = cuda if isinstance(cuda, tuple) else (cuda,)
    for i, (a, b) in enumerate(zip(cuda, cpu)):
      a = a.cpu()
      err = float((a.double() - b.double()).abs().max())
      if name == 'compute_kl':
        ok = torch.allclose(a, b, rtol=KL_RTOL, atol=KL_ATOL)
        rule = f'rtol {KL_RTOL}, atol {KL_ATOL}'
      elif a.dim() == 0:  # a mean over examples
        ok = torch.allclose(a, b, rtol=MEAN_RTOL, atol=0)
        rule = f'rtol {MEAN_RTOL}'
      else:
        ok, rule = torch.equal(a, b), 'torch.equal'
      if not ok:
        raise AssertionError(f'{name}[{i}]: card != CPU (max |d| {err})')
      log(f'  (d) {name}[{i}] {tuple(a.shape)}: card vs CPU {rule}, max |d| '
          f'{err}')
  log(f'  (d) sizes: one-hots (N, T, H, W, C) = {MATH_SIZES["iou"]}, KL '
      f'(4, {h * w}), inpaint (N, H, W) = {MATH_SIZES["inpaint"]} '
      f'({ih * iw} pixels, a ({ih * iw}, {ih * iw}) distance table); '
      f'{power}')
  if importlib.util.find_spec('h5py') is None:
    log('  (e) h5py is not installed on this machine: the Keras .h5 '
        'InceptionV3 loader (eval/inception.load_keras_weights) is not run '
        'here; convert the .h5 where h5py is installed with python -m '
        'se3ds_torch.convert_inception (the CPU tests hold it to JAX)')
  else:
    log('  (e) h5py is installed here, but this phase does not run the .h5 '
        'loader (no ImageNet .h5 in the repository; the CPU tests hold it '
        'to JAX)')


# -- phase 13: the serving calls as captured CUDA graphs ---------------------

GRAPH_PASSES, GRAPH_TIMED, GRAPH_CHECK_PASSES = 5, 3, 3
GRAPH_TRAJECTORY = np.array([[1.0, 0.1 * t, 0.0] for t in range(3)],
                            np.float32)
# Forwards (each two splats) and calls per pass of `graph_sequence`.
GRAPH_FORWARDS, GRAPH_CALLS = 3 + 2 + len(GRAPH_TRAJECTORY) + 1, 8


def graph_sequence(model, pano, poses, timing):
  """One pass: reset_memory, add_to_memory, 3 feedback steps, 2 read-only
  calls, predict_trajectory T=3 and predict_poses K=8. Returns the
  (call, OutputData) pairs; appends (wall ms, host CPU ms, host ms) per
  call to `timing[call]`: the wall time to the synchronise after it, the
  calling thread's CPU time and the wall time until the call returned."""
  outs = []

  def call(name, fn):
    sync()
    t0, cpu0 = time.perf_counter(), time.thread_time()
    out = fn()
    returned, cpu = time.perf_counter(), time.thread_time()
    sync()
    timing.setdefault(name, []).append(
        ((time.perf_counter() - t0) * 1e3, (cpu - cpu0) * 1e3,
         (returned - t0) * 1e3))
    if out is not None:
      outs.append((name, out))

  model.reset_memory()
  call('add', lambda: model.add_to_memory(*pano, np.zeros((1, 3),
                                                          np.float32)))
  for i in range(3):
    call('step', lambda: model(
        np.array([[0.25 * (i + 1), 0.1, 0.0]], np.float32),
        add_preds_to_memory=True))
  for i in range(2):
    call('read', lambda: model(np.array([[0.4, 0.1 * i, 0.0]], np.float32)))
  call('trajectory', lambda: model.predict_trajectory(GRAPH_TRAJECTORY))
  call('poses', lambda: model.predict_poses(poses))
  return outs


def differing_values(a_outs, b_outs):
  """Values that differ between two passes' OutputData, per field."""
  diff = {}
  for (name, a), (_, b) in zip(a_outs, b_outs):
    for field in a._fields:
      x, y = getattr(a, field), getattr(b, field)
      if x is not None:
        diff[field] = diff.get(field, 0) + int((x != y).sum())
  return {k: v for k, v in diff.items() if v}


def graph_passes(models, pano, poses, passes, timed=0):
  """`passes` passes of graph_sequence on each model, in turns; returns
  (outputs per model, timing per model of the last `timed` passes)."""
  outs = {name: [] for name in models}
  timing = {name: {} for name in models}
  for p in range(passes):
    order = list(models) if p % 2 == 0 else list(models)[::-1]
    for name in order:
      t = timing[name] if p >= passes - timed else {}
      outs[name].append(graph_sequence(models[name], pano, poses, t))
  return outs, timing


def phase_graphs(inference, model_config, splat_cuda, power):
  """13: the serving calls of one model replayed from captured CUDA
  graphs against an eager model with the same seeded weights and inputs,
  on phase 4's config: every OutputData field torch.equal, 'fast' then
  'pallas_exact'; ms per warm step, per trajectory frame and per pose,
  host CPU ms per step, each key's capture seconds, the graphs and their
  pool."""
  from se3ds_torch.models import graphs as graphs_lib
  log('== phase 13: the serving calls as captured CUDA graphs against '
      'eager, phase 4\'s config (1024x512, gen_dims 128, ResNet-101, bf16) '
      '==')
  models = {name: inference.SE3DSModel(
      serving_config(model_config), device='cuda',
      generator=torch.Generator(device='cuda').manual_seed(0),
      cuda_graphs=name == 'graph') for name in ('eager', 'graph')}
  eager, graph = models['eager'], models['graph']
  weights = [m.model.state_dict() for m in (eager, graph)]
  if not all(torch.equal(weights[0][k], weights[1][k]) for k in weights[0]):
    raise AssertionError('the two models\' seeded weights differ')
  log(f'  eager model: {eager.uncaptured}; graph model: every entry point '
      f'captured ({graph.uncaptured}); a model with mesh= runs eagerly '
      '(decided at construction: NCCL capture is a later slice); every '
      'splat mode captures (tests/test_torch_cuda.py)')
  pano = synthetic_pano(H, 0)
  poses = np.random.RandomState(5).uniform(-0.8, 0.8, (POSES_K, 3)).astype(
      np.float32) * np.array([1, 1, 0.1], np.float32)

  def check(mode, outs, passes, deterministic):
    fast = tracing.count(FAST)
    exact = tracing.count(EXACT)
    want = 2 * 2 * GRAPH_FORWARDS * passes
    if (fast, exact) != ((want, 0) if mode == 'fast' else (0, want)):
      raise AssertionError(f'{mode}: launches (fast, exact) {(fast, exact)};'
                           f' expected {want} of its kernel')
    against = [differing_values(a, b)
               for a, b in zip(outs['eager'], outs['graph'])]
    repeat = [differing_values(outs['eager'][0], b)
              for b in outs['eager'][1:]]
    log(f'  {mode} (cuDNN {"deterministic" if deterministic else "defaults"}'
        f', {passes} passes of add + 3 steps + 2 reads + trajectory T='
        f'{len(GRAPH_TRAJECTORY)} + poses K={POSES_K}): values differing '
        f'graph vs eager per pass {against}; eager pass 1 vs later passes '
        f'{repeat}; {fast + exact} {mode} point passes, kernel launches '
        f'counted through the replays ({power})')
    return any(against), any(repeat), fast, exact

  # (a) 'fast' under cuDNN's defaults, timed.
  tracing.reset()
  outs, timing = graph_passes(models, pano, poses, GRAPH_PASSES,
                              GRAPH_TIMED)
  replays = tracing.count('serve.replays')
  captures = {name: span['host_ms'] for name, span in
              tracing.snapshot()['spans'].items()
              if name.endswith('.capture')}
  if replays != 1 + GRAPH_CALLS * (GRAPH_PASSES - 1):
    raise AssertionError(f'{replays} replays: every call after the first '
                         'of its key should replay')
  apart, eager_apart, fast, _ = check('fast', outs, GRAPH_PASSES, False)
  launches = {'fast': fast, 'exact': 0}
  resolution = time.get_clock_info('thread_time').resolution * 1e3
  for name in models:
    t = timing[name]
    med = lambda call, i=0: statistics.median(v[i] for v in t[call])
    # The thread clock may tick coarsely: its mean over the calls.
    cpu = lambda call: statistics.mean(v[1] for v in t[call])
    frames = len(GRAPH_TRAJECTORY)
    log(f'  {name}: ms per warm step {med("step"):.2f} (median of '
        f'{len(t["step"])}; the call returns after {med("step", 2):.2f}, '
        f'host CPU {cpu("step"):.2f} ms a step, mean); read-only call '
        f'{med("read"):.2f} ms (host CPU {cpu("read"):.2f}); add_to_memory '
        f'{med("add"):.2f} ms; per trajectory frame '
        f'{med("trajectory") / frames:.2f} ms (host CPU '
        f'{cpu("trajectory") / frames:.2f}); per pose '
        f'{med("poses") / POSES_K:.2f} ms at K={POSES_K} (host CPU '
        f'{cpu("poses") / POSES_K:.2f}); thread clock resolution '
        f'{resolution:.3g} ms ({power})')
  programs = graph.graphs
  log(f'  graph model: {len(programs.graphs)} graphs, {replays} replays, '
      f'pool {programs.pool_bytes() / 2**30:.3f} GiB; capture s per key: '
      + ', '.join(f'{name} {[round(ms / 1e3, 3) for ms in each]}'
                  for name, each in captures.items()) + f' ({power})')
  if apart and not eager_apart:
    raise AssertionError('graph != eager under cuDNN defaults, while the '
                         'eager model repeats its own bits')

  # (b) 'pallas_exact' (the exact kernel's cooperative launch captured);
  # (c) a mode whose eager runs differ from each other (cuDNN's default
  # algorithms summing in any order) again with deterministic ones.
  runs = [('pallas_exact', False)] + ([('fast', True)] if apart else [])
  for mode, deterministic in runs:
    torch.backends.cudnn.deterministic = deterministic
    try:
      for model in models.values():
        model.config = dataclasses.replace(model.config, splat_mode=mode)
      graph.graphs = graphs_lib.Programs()  # captured anew for the mode
      set_launches()
      outs, _ = graph_passes(models, pano, poses, GRAPH_CHECK_PASSES)
      mode_apart, mode_eager_apart, fast, exact = check(
          mode, outs, GRAPH_CHECK_PASSES, deterministic)
      launches['fast'] += fast
      launches['exact'] += exact
      if mode_apart and (deterministic or not mode_eager_apart):
        raise AssertionError(f'{mode}: graph != eager')
      if mode_apart:
        runs.append((mode, True))
    finally:
      torch.backends.cudnn.deterministic = False
  del models, eager, graph, programs
  torch.cuda.empty_cache()
  return launches


def main():
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this script runs on the card.',
          file=sys.stderr)
    return 2
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from se3ds_torch.models import inference
  from se3ds_torch.models import model_config
  from se3ds_torch.ops import cuda_build
  from se3ds_torch.ops import geometry
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
    if info.exists():  # each kernel's registers and shared memory
      log(f'  {name}:')
      for line in info.read_text().splitlines():
        if 'entry function' in line or 'Used' in line:
          log(f'    {line.strip()}')
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False

  seconds = {'1': time.perf_counter() - START}

  def run(name, fn, *args):
    t = time.perf_counter()
    out = fn(*args)
    seconds[name] = time.perf_counter() - t
    log(f'  (phase {name}: {seconds[name]:.1f} s)')
    return out

  max_err = run('2', phase_kernel_parity, splat_cuda, geometry, power)
  run('3', phase_small_vs_cpu, inference, model_config)
  launches, main_err, fast, epilogue_launches, wrap_launches = run(
      '4', phase_serving, inference, model_config, splat_cuda, power)
  generator_kernels = run('4b', phase_generator_kernels, inference,
                          model_config, power)
  epilogue, wrap = generator_kernels['epilogue'], generator_kernels['wrap']
  exact_err = run('5', phase_exact_parity, splat_cuda, geometry, power)
  exact_launches, rollout_err, exact = run(
      '6', phase_eval, inference, model_config, splat_cuda, power)
  run('6b', phase_eval_small_vs_cpu, inference, model_config)
  run('7', phase_train, power)
  run('7b', phase_train_small_vs_cpu)
  cli_launches, cli_err, cli_model_dir, cli_root = run(
      '8', phase_cli, splat_cuda, power)
  try:
    api_launches, api_err = run('9', phase_serving_api, inference,
                                model_config, splat_cuda, geometry, power,
                                cli_model_dir)
    run('11d', phase_test_torchrun, power, cli_model_dir, cli_root)
    shutil.rmtree(cli_model_dir)  # phase 10f reads only the records
    run('10', phase_highres, power)
    run('10de', phase_remat_and_group)
    run('10f', phase_torchrun, power, cli_root)
  finally:
    shutil.rmtree(cli_root)
  mode_launches, mode_err, mode_ms = run('11a', phase_modes, inference,
                                         model_config, splat_cuda, power)
  mesh_launches, mesh_err, split_ms = run('11bc', phase_mesh, inference,
                                          model_config, splat_cuda, geometry,
                                          power)
  release_launches = run('12', phase_release_checkpoint, inference,
                         model_config, splat_cuda, power)
  run('12d', phase_math_utils, power)
  graph_launches = run('13', phase_graphs, inference, model_config,
                       splat_cuda, power)
  # A kernel's time: its point pass(es) and its resolve, on the device.
  fast_ms = fast['point'] + fast['resolve']
  exact_ms = exact['point'] + exact['resolve']
  log(f'splat_fast per served frame (semantic + RGB, 1024x512, main path): '
      f'point passes {fast["point"]:.4f} ms + resolves {fast["resolve"]:.4f}'
      f' ms, whole stage {fast["stage"]:.4f} ms, plain {fast["plain"]:.4f} '
      f'ms, bound {fast["bound"]:.4f} ms')
  log(f'splat_exact per rollout frame (batch {EVAL_BATCH}, C=3, 1024x512): '
      f'launch {exact["point"]:.4f} ms + resolve {exact["resolve"]:.4f} ms,'
      f' whole stage {exact["stage"]:.4f} ms, plain {exact["plain"]:.4f} ms,'
      f' bound {exact["bound"]:.4f} ms')
  fast_11 = mode_launches['fast'] + mesh_launches['fast']
  exact_11 = mode_launches['exact'] + mesh_launches['exact']
  log(f'splat_fast launches: {launches} in phase 4, {api_launches} in '
      f'phase 9, {fast_11} in phase 11, {release_launches} in phase 12, '
      f'{graph_launches["fast"]} in phase 13 (the kernels line counts all '
      'five)')
  log(f'splat_exact launches: {exact_launches} in phase 6\'s rollout, '
      f'{cli_launches} in phase 8\'s TEST, {exact_11} in phase 11 (its split'
      f' passes one each), {graph_launches["exact"]} in phase 13 (the kernels'
      ' line counts phases 8, 11 and 13)')
  log('splat stage per served frame by mode (phase 11a, device ms): '
      + ', '.join(f'{k} {v:.4f}' for k, v in mode_ms.items()))
  mesh_stage_ms = split_ms.pop('mesh stage')
  log('split exact passes per served frame (phase 11b, device ms): '
      + ', '.join(f'{k} {v:.4f}' for k, v in split_ms.items()))
  log('splat stage per served frame without / with the world-1 mesh '
      '(phase 11b, device ms): ' + ', '.join(
          f'{k} {a:.4f} / {b:.4f}' for k, (a, b) in mesh_stage_ms.items()))
  log('conv epilogue per served generator call (1024x512, bf16, phase '
      '4b, device ms): ' + ', '.join(
          f'batch {b}: kernel {e["ms"]:.4f}, plain {e["plain_ms"]:.4f}, '
          f'bound {e["bound_ms"]:.4f}, {e["launches"]} launches'
          for b, e in epilogue.items()))
  log(f'conv epilogue launches: {epilogue_launches} in phase 4 (the kernels '
      'line counts the main path\'s)')
  log('circular wrap per served generator call (1024x512, bf16, phase '
      '4b, device ms): ' + ', '.join(
          f'batch {b}: kernel {e["ms"]:.4f}, plain {e["plain_ms"]:.4f}, '
          f'bound {e["bound_ms"]:.4f}, {e["launches"]} launches'
          for b, e in wrap.items()))
  log(f'circular wrap launches: {wrap_launches} in phase 4 (the kernels '
      'line counts the main path\'s)')
  log(f'chip_smoke took {time.perf_counter() - START:.1f} s; by phase: '
      + ', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()))
  log(power)

  log(json.dumps({'kernels': [{
      'name': 'splat_fast', 'route': 'cuda',
      'source': 'se3ds_torch/csrc/splat.cu', 'replaces': SPLAT_REPLACES,
      'launches': (launches + api_launches + fast_11 + release_launches
                   + graph_launches['fast']),
      'max_abs_err': max(max_err, main_err, api_err, mesh_err),
      'ms': fast_ms, 'plain_ms': fast['plain'], 'bound_ms': fast['bound'],
      'bound_by': 'bytes', 'library_ms': None}, {
          'name': 'splat_exact', 'route': 'cuda',
          'source': 'se3ds_torch/csrc/splat_exact.cu',
          'replaces': EXACT_REPLACES,
          'launches': cli_launches + exact_11 + graph_launches['exact'],
          'max_abs_err': max(exact_err, rollout_err, cli_err, mode_err,
                             mesh_err),
          'ms': exact_ms,
          'plain_ms': exact['plain'], 'bound_ms': exact['bound'],
          'bound_by': 'bytes', 'library_ms': None}, {
          'name': 'conv_epilogue', 'route': 'cuda',
          'source': 'se3ds_torch/csrc/epilogue.cu', 'replaces': None,
          'launches': epilogue_launches,
          'max_abs_err': max(e['max_err'] for e in epilogue.values()),
          'ms': epilogue[1]['ms'], 'plain_ms': epilogue[1]['plain_ms'],
          'bound_ms': epilogue[1]['bound_ms'], 'bound_by': 'bytes',
          'library_ms': None}, {
          'name': 'circular_wrap', 'route': 'cuda',
          'source': 'se3ds_torch/csrc/wrap.cu', 'replaces': None,
          'launches': wrap_launches,
          'max_abs_err': max(e['max_err'] for e in wrap.values()),
          'ms': wrap[1]['ms'], 'plain_ms': wrap[1]['plain_ms'],
          'bound_ms': wrap[1]['bound_ms'], 'bound_by': 'bytes',
          'library_ms': None}]}))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
