"""What the serving drivers share: the weights, the program, the
reference and the comparison that decides `correct`.

Set-up makes the weights on the device from the seed (`weights.py`),
sets the BatchNorm statistics from one calibration pass of the
reference over the cell's first request, keeps a host copy, and builds
the program from it through `SE3DSModel(variables=...)`. After the
window the program is freed and the reference, float32 with TF32 off,
recomputes the sampled calls from the same host copy of the weights.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark import harness
from benchmark import weights as weights_lib
from benchmark.reference import generator as ref_gen
from benchmark.reference import geometry as ref_geo


@contextlib.contextmanager
def strict_float32():
  """float32 convolutions and matmuls without TF32."""
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def reference(model_cfg: Dict, device, numerics=None) -> ref_gen.Generator:
  with torch.device(device):
    return ref_gen.Generator(model_cfg['gen_dims'],
                             model_cfg['resnet_version'],
                             model_cfg['use_blurred_mask'],
                             numerics).eval().requires_grad_(False)


def frame(write, height_cfg: Dict, device) -> ref_geo.Frame:
  """The reference's memory frame of one write (rgb, semantic, depth,
  position), numpy arrays with a leading batch of 1."""
  rgb, sem, depth, position = write
  as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
  return ref_geo.memory_frame(as_t(rgb), as_t(sem)[..., 0], as_t(depth),
                              as_t(position), height_cfg['depth_scale'],
                              height_cfg['pole_compact'])


class Setup:
  """The weights of a run: made on `device` from the seed, calibrated on
  the cell's first request (its memory `first_frames`, those of them that
  hold semantics, and its positions), then kept on the host."""

  def __init__(self, cell, seed: int, device, first_frames: Sequence,
               first_sem: Sequence, first_positions: np.ndarray):
    model_cfg = cell.config['model']
    self.model_cfg = model_cfg
    frames = [frame(w, model_cfg, device) for w in first_frames]
    sem = [frame(w, model_cfg, device) for w in first_sem]
    guide = ref_geo.guidance(frames, sem, torch.as_tensor(
        first_positions, device=device), model_cfg['image_height'],
                             model_cfg['depth_scale'])
    made = make_weights(model_cfg, cell.config['assumed'], seed, device,
                        guide.inputs)
    self.host = made.to('cpu')
    del made, frames, sem, guide
    harness.release(device)


def make_weights(model_cfg: Dict, assumed: Dict, seed: int, device,
                 inputs) -> weights_lib.Weights:
  """Seeded weights, then one calibration pass of the reference over
  `inputs`: the last BatchNorm of each output head is scaled, and the
  head's last bias set, so that the head's output before its activation
  has the (mean, std) of `assumed['heads']` (a mid-grey RGB, walls a
  few metres away), as a trained model's would."""
  with torch.device('meta'):
    leaves = weights_lib.flax_leaves(reference(model_cfg, 'meta'))
  made = weights_lib.Weights.make(leaves, seed, device)
  numerics = ref_gen.Numerics(calibrate=True)
  model = reference(model_cfg, device, numerics)
  ref_gen.load_flax(model, made.tree)
  with torch.no_grad(), strict_float32():
    model(inputs)
  with torch.no_grad():
    for head, (target_mean, target_std) in assumed['heads'].items():
      mean, std = numerics.heads[head]
      scale = target_std / float(std)
      made.leaf('params', (f'{head}_conv', 'bn2', 'bn', 'scale')).fill_(scale)
      made.leaf('params', (f'{head}_conv', 'conv2', 'bias')).fill_(
          target_mean - scale * float(mean))
  return made



def se3ds_config(cell, **overrides):
  from se3ds_torch.models import model_config
  return model_config.SE3DSConfig(**{**cell.config['model'], **overrides})


# A served value this far from the reference's counts as off: 8 levels of
# 255 for RGB, 0.01 of the depth scale (20 cm at 20 m) for depth.
RGB_OFF_LEVELS = 8
DEPTH_OFF = 0.01
SERVED = ('rgb_mae', 'depth_mae', 'rgb_off_share', 'depth_off_share')


class Comparison:
  """The program's outputs against the reference's, call by call.

  Readings (the worst view over the compared calls):
  - guidance_px: pixels whose guidance (RGB, depth, mask or semantics)
    differs from the reference's splat of the same memory;
  - rgb_mae: mean |served RGB - reference RGB| in levels of 255;
  - depth_mae: mean |served depth - reference depth| in [0, 1] depth;
  - rgb_off_share, depth_off_share: the share of served RGB values, and
    of depth pixels, off by more than RGB_OFF_LEVELS and DEPTH_OFF;
  - memory_pts: points of the program's memory that differ from the
    reference's unprojection of what was written (`memory`).
  The control (`control=True`) runs the reference in float8 beside it
  and reads the same served numbers against the float32 reference.
  """

  def __init__(self, setup: Setup, device, control: bool = False):
    self.cfg = setup.model_cfg
    self.device = device
    weights = setup.host.to(device)
    self.model = reference(self.cfg, device)
    ref_gen.load_flax(self.model, weights.tree)
    self.control = None
    if control:
      self.control = reference(self.cfg, device, ref_gen.Numerics(fp8=True))
      ref_gen.load_flax(self.control, weights.tree)
    del weights
    self.readings = {'guidance_px': 0.0, 'memory_pts': 0.0,
                     **dict.fromkeys(SERVED, 0.0)}
    self.control_readings = dict.fromkeys(SERVED, 0.0)
    self.compared = 0

  def frame(self, write) -> ref_geo.Frame:
    return frame(write, self.cfg, self.device)

  @torch.no_grad()
  def call(self, frames: List[ref_geo.Frame], sem: List[ref_geo.Frame],
           positions: np.ndarray, out, block: int = 4) -> None:
    """Compares one served call (OutputData of K views at `positions`)."""
    positions = torch.as_tensor(positions, device=self.device)
    for k0 in range(0, positions.shape[0], block):
      guide = ref_geo.guidance(frames, sem, positions[k0:k0 + block],
                               self.cfg['image_height'],
                               self.cfg['depth_scale'])
      part = lambda x: x[k0:k0 + block].to(self.device)
      differs = ((part(out.proj_rgb) != guide.proj_rgb_u8).any(-1)
                 | (part(out.proj_depth) != guide.proj_depth)
                 | (part(out.proj_mask) != guide.proj_mask)[..., 0]
                 | (part(out.proj_semantic) != guide.proj_semantic_u8))
      self._note('guidance_px', float(differs.sum(dim=(1, 2)).max()))
      with strict_float32():
        rgb, depth = ref_geo.served_outputs(*self.model(guide.inputs))
      self._read(self.readings, part(out.pred_rgb), part(out.pred_depth),
                 rgb, depth)
      if self.control is not None:
        with strict_float32():
          c_rgb, c_depth = ref_geo.served_outputs(*self.control(guide.inputs))
        self._read(self.control_readings, c_rgb, c_depth, rgb, depth)
    self.compared += 1

  def _read(self, readings, rgb, depth, ref_rgb, ref_depth):
    rgb_err = (rgb.to(torch.float32) - ref_rgb.to(torch.float32)).abs()
    depth_err = (depth - ref_depth).abs()
    worst = {
        'rgb_mae': rgb_err.mean(dim=(1, 2, 3)),
        'depth_mae': depth_err.mean(dim=(1, 2)),
        'rgb_off_share': (rgb_err > RGB_OFF_LEVELS).float().mean(
            dim=(1, 2, 3)),
        'depth_off_share': (depth_err > DEPTH_OFF).float().mean(dim=(1, 2))}
    for key, per_view in worst.items():
      readings[key] = max(readings[key], float(per_view.max()))

  def _note(self, key, value):
    self.readings[key] = max(self.readings[key], value)

  @torch.no_grad()
  def memory(self, state, slots: Dict[int, ref_geo.Frame]) -> None:
    """Counts the points of the program's memory (a MemoryState: H*W
    semantic and, with pole compaction, (r1 - r0)*W RGB points a frame
    slot) that differ from the reference's frame at each slot."""
    height = self.cfg['image_height']
    hw = height * 2 * height
    r0, r1 = (ref_geo.pole_valid_rows(height) if self.cfg['pole_compact']
              else (0, height))
    rgb_frame_points = (r1 - r0) * 2 * height
    bad = 0
    for slot, fr in slots.items():
      s0, r0 = slot * hw, slot * rgb_frame_points
      sem_xyz = state.coords[0, :, s0:s0 + hw].to(self.device)
      sem = state.feats[0, s0:s0 + hw].to(self.device)
      rgb_xyz = state.rgb_coords[0, :, r0:r0 + rgb_frame_points].to(
          self.device)
      rgb = state.rgb[0, r0:r0 + rgb_frame_points].to(self.device)
      bad += int(((sem_xyz != fr.sem_xyz[0]).any(0)
                  | (sem != fr.sem[0]).any(-1)).sum())
      bad += int(((rgb_xyz != fr.rgb_xyz[0]).any(0)
                  | (rgb != fr.rgb[0]).any(-1)).sum())
    self._note('memory_pts', float(bad))


def checks(comparison: Comparison, limits: Dict[str, float]):
  return {name: (comparison.readings[name], limits[name]) for name in limits}


