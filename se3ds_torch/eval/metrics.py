"""FID/RMSE evaluation with the autoregressive rollout (port of
`se3ds_tpu.eval.metrics`).

The rollout follows the JAX package frame for frame: a point-cloud
memory accumulates frames (frame 0: the pole-masked ground truth; frames
t > 0: the generator's own RGB output and predicted depth), each next
frame is conditioned on the memory splat at its pose, and per-frame
Inception pools and depth RMSE are collected for frames 1..T-1. The
memory is a fixed-capacity buffer written in place; each frame splats
only the frames written so far.

Everything runs on the card unless the caller passes `device='cpu'`;
random augmentations draw from an explicit `torch.Generator`. Batches
come from any iterator of numpy (or tensor) dicts; the JAX package's data
pipeline is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from se3ds_torch import constants
from se3ds_torch import device as device_lib
from se3ds_torch.eval import fid as fid_lib
from se3ds_torch.eval import inception as inception_lib
from se3ds_torch.ops import geometry

log = logging.getLogger('se3ds_torch')


def augment_crop(images: torch.Tensor, roll: int,
                 flips: torch.Tensor) -> torch.Tensor:
  """Rolls the (N, H, W, C) batch by `roll` columns, flips the images
  where `flips` is True, then crops the poles (`geometry.crop_pano`)."""
  images = torch.roll(images, roll, dims=2)
  flips = flips.to(images.device)[:, None, None, None]
  images = torch.where(flips, images.flip(2), images)
  return geometry.crop_pano(images, resize_to_original=False)


def draw_augment(batch_size: int, width: int, rng: torch.Generator
                 ) -> Tuple[int, torch.Tensor]:
  """One roll in [-width/2, width/2) for the batch and one fair flip per
  image, as the reference augment draws them (indoor_datasets.py:34-61)."""
  roll = torch.randint(-width // 2, width // 2, (), generator=rng,
                       device=rng.device)
  flips = torch.rand(batch_size, generator=rng, device=rng.device) < 0.5
  return int(roll), flips


def _augment_crop_for_inception(images: torch.Tensor,
                                rng: torch.Generator) -> torch.Tensor:
  """Random roll + flip, then pole crop (JAX
  `metrics._augment_crop_for_inception`)."""
  roll, flips = draw_augment(images.shape[0], images.shape[2], rng)
  return augment_crop(images, roll, flips)


def _video(batch: Dict[str, Any], key: str,
           device: torch.device) -> torch.Tensor:
  return torch.as_tensor(batch[key], dtype=torch.float32, device=device)


@torch.no_grad()
def rollout_generated(generator: Callable,
                      batch: Dict[str, Any],
                      eval_seq_len: int,
                      depth_scale: float,
                      predict_depth: bool = True,
                      splat_mode: str = 'sorted',
                      device=None):
  """Runs the autoregressive rollout (JAX `metrics.rollout_generated`).

  The default splat mode is 'sorted', the exact reference winner
  selection (min depth + 0.1 m window + per-channel max); on the card all
  exact modes run the exact CUDA splat.

  Args:
    generator: fn(conditions dict) -> the generator's 7-output list, e.g.
      a `ResNetGenerator`.
    batch: video batch with image (N,T,H,W,3) in [0, 1], depth
      (N,T,H,W,1) in [0, 1] and position (N,T,4), numpy or tensors.
    eval_seq_len: frames to roll out (<= T).
    depth_scale: metres.
    predict_depth: feed the generator's depth back into the memory.
    splat_mode: see `geometry.project_feats_to_equirectangular`.
    device: 'cuda' (default; raises without a card) or 'cpu'.

  Returns:
    generated: dict frame_idx -> (N,H,W,3) for frames 0..eval_seq_len-1.
    rmse: dict frame_idx -> (N,) depth RMSE for the same frames.
    aux: 'pred_depth' (the depth fed to memory), 'projected' (guidance
      RGB in [0, 1]), 'blurred_mask' and 'proj_mask', each a dict
      frame_idx -> (N,H,W,C).
  """
  device = device_lib.resolve(device, 'rollout_generated')
  images = _video(batch, 'image', device)
  depths = _video(batch, 'depth', device)
  positions = _video(batch, 'position', device)
  n, _, height, width, _ = images.shape
  frame_points = height * width
  void = constants.INVALID_RGB_VALUE

  memory_coords = torch.zeros((n, 4, eval_seq_len * frame_points),
                              device=device)
  memory_feats = torch.full((n, eval_seq_len * frame_points, 3), float(void),
                            device=device)
  prev_rgb = torch.zeros((n, height, width, 3), device=device)
  # A 0-dim divisor: PyTorch's CUDA division by a Python scalar multiplies
  # by its reciprocal, which would move the guidance by an ULP off the
  # CPU's (and JAX's) bits.
  byte_scale = torch.full((), 255.0, device=device)
  depth_tensor = depths[:, 0]
  all_generated, all_rmse = {}, {}
  aux = {'pred_depth': {}, 'projected': {}, 'blurred_mask': {},
         'proj_mask': {}}

  for frame_idx in range(eval_seq_len):
    target_depth = depths[:, frame_idx]
    rgb_tensor = images[:, frame_idx]
    if not predict_depth or frame_idx == 0:
      depth_tensor = depths[:, frame_idx]

    relative_position = positions[:, frame_idx]
    # Only max(1, frame_idx) frames are written; the rest is void.
    extent = max(1, frame_idx) * frame_points
    pred_depth, pred_rgb = geometry.project_feats_to_equirectangular(
        memory_feats[:, :extent],
        memory_coords[:, :, :extent] - relative_position[..., None],
        height, width, void_class=void, depth_scale=depth_scale,
        splat_mode=splat_mode)
    pred_mask = ((pred_depth > 0) & (pred_depth < 1)
                 & torch.all(pred_rgb != void, dim=-1)
                 ).to(torch.float32)[..., None]
    pred_depth = pred_depth[..., None]
    pred_rgb = torch.clamp(pred_rgb / byte_scale, 0.0, 1.0)
    blurred_mask = torch.zeros_like(pred_depth)

    outputs = generator({
        'prev_image': prev_rgb,
        'proj_image': pred_rgb,
        'proj_mask': pred_mask,
        'proj_depth': pred_depth,
        'blurred_mask': blurred_mask,
    })
    depth_out, generated = outputs[3], outputs[6]

    if frame_idx == 0:
      prev_rgb = rgb_tensor
      rgb_tensor = geometry.mask_pano(rgb_tensor, masked_region_value=void)
    else:
      rgb_tensor = generated
      prev_rgb = generated
      if depth_out is not None and predict_depth:
        depth_tensor = depth_out

    aux['pred_depth'][frame_idx] = depth_tensor
    aux['projected'][frame_idx] = pred_rgb
    aux['blurred_mask'][frame_idx] = blurred_mask
    aux['proj_mask'][frame_idx] = pred_mask

    # RMSE on the depth fed to the memory (predicted for frames > 0).
    target_mask = ((target_depth > 0) & (target_depth < 1)).to(torch.float32)
    depth_diff = torch.sum((depth_tensor - target_depth)**2 * target_mask,
                           dim=(1, 2, 3)) / torch.clamp(
                               torch.sum(target_mask, dim=(1, 2, 3)), min=1.0)
    all_rmse[frame_idx] = torch.sqrt(depth_diff)

    # Unproject the frame into its memory slot. int32 truncates toward 0.
    pc_rgb = torch.clamp((rgb_tensor * 255).to(torch.int32), void, 255)
    xyz1, feats = geometry.equirectangular_to_pointcloud(
        pc_rgb, depth_tensor[..., 0], void_class=void,
        depth_scale=depth_scale)
    offset = frame_idx * frame_points
    memory_coords[:, :, offset:offset + frame_points] = (
        xyz1 + relative_position[..., None])
    memory_feats[:, offset:offset + frame_points] = feats.to(torch.float32)
    all_generated[frame_idx] = generated

  return all_generated, all_rmse, aux


class EvalMetric:
  """FID + RMSE evaluator (JAX `metrics.EvalMetric`).

  `ds_factory()` returns an iterator of batches (dicts of numpy arrays or
  tensors) with 'image', 'depth', 'position' and 'original_image'
  (N,T,H,W,3), as the JAX data pipeline yields them. The real-image pools
  are computed once, at construction.
  """

  def __init__(self,
               ds_factory: Callable[[], Iterator[Dict[str, Any]]],
               eval_num: int,
               batch_size: int,
               avg_num: int = 3,
               eval_seq_len: int = 5,
               depth_scale: float = constants.DEPTH_SCALE,
               predict_depth: bool = True,
               inception_model: Optional[inception_lib.InceptionV3] = None,
               splat_mode: str = 'sorted',
               rng: Optional[torch.Generator] = None,
               device=None):
    """Args as the JAX EvalMetric's, with the Inception module in place of
    its variables (default: `init_inception` from seed 42), a
    `torch.Generator` for the augmentations (default: seed 0 on
    `device`), and `device` ('cuda' by default; raises without a card)."""
    self.device = device_lib.resolve(device, 'EvalMetric')
    self.ds_factory = ds_factory
    self.eval_num = eval_num
    self.batch_size = batch_size
    self.avg_num = avg_num
    self.eval_seq_len = eval_seq_len
    self.depth_scale = depth_scale
    self.predict_depth = predict_depth
    self.splat_mode = splat_mode
    self._rng = (rng if rng is not None
                 else torch.Generator(device=self.device).manual_seed(0))
    self._inception = (inception_model if inception_model is not None
                       else inception_lib.init_inception(
                           torch.Generator(device=self.device).manual_seed(
                               42)))
    self._pool = self._get_real_pool_for_evaluation()

  def _batches(self) -> Iterator[Dict[str, Any]]:
    """eval_num // batch_size + 1 batches, restarting the data when it
    runs out (the reference's count; the pools are trimmed after)."""
    n_iter = self.eval_num // self.batch_size + 1
    ds = self.ds_factory()
    for j in range(n_iter):
      try:
        batch = next(ds)
      except StopIteration:
        ds = self.ds_factory()
        batch = next(ds)
      if j % 10 == 0:
        log.info('Eval batch %d / %d', j, n_iter)
      yield batch

  def _pool_of(self, images: torch.Tensor):
    """Inception (pool, predictions) of augmented, pole-cropped images."""
    return inception_lib.get_inception(
        _augment_crop_for_inception(images, self._rng), self._inception)

  def _trim(self, lists):
    return {k: np.concatenate(v, 0)[:self.eval_num] for k, v in lists.items()}

  def _get_real_pool_for_evaluation(self):
    log.info('Get pool for %d samples', self.eval_num)
    pools = {i: [] for i in range(1, self.eval_seq_len)}
    for batch in self._batches():
      images = _video(batch, 'original_image', self.device)
      for i in range(1, self.eval_seq_len):
        pools[i].append(self._pool_of(images[:, i])[0].cpu().numpy())
    return self._trim(pools)

  def _get_generated_pool_for_evaluation(self, generator: Callable):
    frames = range(1, self.eval_seq_len)
    pools = {i: [] for i in frames}
    logits = {i: [] for i in frames}
    rmse = {i: [] for i in frames}
    for batch in self._batches():
      generated, batch_rmse, _ = rollout_generated(
          generator, batch, self.eval_seq_len, self.depth_scale,
          self.predict_depth, splat_mode=self.splat_mode, device=self.device)
      for i in frames:
        pool, preds = self._pool_of(generated[i])
        pools[i].append(pool.cpu().numpy())
        logits[i].append(preds.cpu().numpy())
        rmse[i].append(batch_rmse[i].cpu().numpy())
    return self._trim(pools), self._trim(logits), self._trim(rmse)

  def calculate_fid_score(self, generator: Callable):
    """Returns (fid, fid_std, rmse, inception_score) dicts keyed by frame
    index 1..T-1; `generator` maps the conditions dict to the 7-list."""
    fid_list = {i: [] for i in range(1, self.eval_seq_len)}
    rmse_list = {i: [] for i in range(1, self.eval_seq_len)}
    is_list = {i: [] for i in range(1, self.eval_seq_len)}
    log.info('Calculate Generator Statistics')
    for _ in range(self.avg_num):
      generated_pool, logits, rmse_total = (
          self._get_generated_pool_for_evaluation(generator))
      for i in range(1, self.eval_seq_len):
        fid_list[i].append(
            fid_lib.calculate_fid(generated_pool[i], self._pool[i]))
        rmse_list[i].append(np.mean(rmse_total[i]))
        num_splits = max(1, min(10, logits[i].shape[0] // 2))
        is_list[i].append(
            fid_lib.calculate_inception_score(logits[i], num_splits)[0])
    fid = {k: float(np.mean(v)) for k, v in fid_list.items()}
    fid_std = {k: float(np.std(v)) for k, v in fid_list.items()}
    rmse = {k: float(np.mean(v)) for k, v in rmse_list.items()}
    inception_score = {k: float(np.mean(v)) for k, v in is_list.items()}
    return fid, fid_std, rmse, inception_score
