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
come from any iterator of numpy (or tensor) dicts, such as the port's
`data.datasets.R2RVideoDataset` (what `Trainer.test` evaluates).

`EvalMetric(data=...)` evaluates data-parallel: every rank reads every
batch and rolls out its share of the rows, draws each batch's
augmentations whole (so every rank's generator stays in step and each
row gets its world-1 draw), and rank 0 gathers the pools, logits and
RMSE in row order and computes the scores, which every rank returns.
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
from se3ds_torch.parallel import mesh as mesh_lib

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
                                rng: torch.Generator,
                                rows: slice = slice(None),
                                batch_size: Optional[int] = None
                                ) -> torch.Tensor:
  """Random roll + flip, then pole crop (JAX
  `metrics._augment_crop_for_inception`). `images` are `rows` of a batch
  of `batch_size` (default: the whole batch), whose draws are made."""
  batch_size = images.shape[0] if batch_size is None else batch_size
  roll, flips = draw_augment(batch_size, images.shape[2], rng)
  return augment_crop(images, roll, flips[rows])


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
  # An exact divide on the card too: a multiply by the reciprocal would
  # move the guidance by an ULP off the CPU's (and JAX's) bits.
  byte_scale = device_lib.divisor(255.0, images)
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
    pred_depth, pred_rgb = geometry.project_memory_equirect(
        memory_feats[:, :extent], memory_coords[:, :, :extent],
        relative_position, height, width, void_class=void,
        depth_scale=depth_scale, splat_mode=splat_mode)
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
               device=None,
               data: Optional[mesh_lib.DataParallel] = None):
    """Args as the JAX EvalMetric's, with the Inception module in place of
    its variables (default: `init_inception` from seed 42), a
    `torch.Generator` for the augmentations (default: seed 0 on
    `device`), `device` ('cuda' by default; raises without a card) and
    `data`, this rank's place among the ranks that evaluate together
    (default: world 1; every rank constructs its EvalMetric alike and
    makes the same calls)."""
    self.device = device_lib.resolve(device, 'EvalMetric')
    self.data = data if data is not None else mesh_lib.DataParallel()
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

  def _pool_of(self, images: torch.Tensor, batch_size: int):
    """Inception (pool, predictions) of this rank's rows of a batch of
    `batch_size`, augmented and pole-cropped (None without rows; the
    augmentations are drawn all the same)."""
    images = _augment_crop_for_inception(
        images, self._rng, self.data.share(batch_size), batch_size)
    if not images.shape[0]:
      return None, None
    pool, preds = inception_lib.get_inception(images, self._inception)
    return pool.cpu().numpy(), preds.cpu().numpy()

  def _trim(self, lists):
    """Rank 0: each list's batches (gathered from every rank) joined and
    cut to eval_num rows; None on the other ranks."""
    lists = self.data.gather_rows(lists)
    if lists is None:
      return None
    return {k: np.concatenate(v, 0)[:self.eval_num] for k, v in lists.items()}

  def _get_real_pool_for_evaluation(self):
    log.info('Get pool for %d samples', self.eval_num)
    pools = {i: [] for i in range(1, self.eval_seq_len)}
    for batch in self._batches():
      images = _video(batch, 'original_image', self.device)
      rows = self.data.share(images.shape[0])
      for i in range(1, self.eval_seq_len):
        pools[i].append(self._pool_of(images[rows, i], images.shape[0])[0])
    return self._trim(pools)

  def _get_generated_pool_for_evaluation(self, generator: Callable):
    frames = range(1, self.eval_seq_len)
    pools = {i: [] for i in frames}
    logits = {i: [] for i in frames}
    rmse = {i: [] for i in frames}
    for batch in self._batches():
      size = int(np.shape(batch['image'])[0])
      rows = self.data.share(size)
      local = {k: batch[k][rows] for k in ('image', 'depth', 'position')}
      if rows.stop > rows.start:
        generated, batch_rmse, _ = rollout_generated(
            generator, local, self.eval_seq_len, self.depth_scale,
            self.predict_depth, splat_mode=self.splat_mode,
            device=self.device)
      else:  # no rows here; the augmentations are drawn all the same
        empty = _video(local, 'image', self.device)[:, 0]
        generated = {i: empty for i in frames}
        batch_rmse = {i: None for i in frames}
      for i in frames:
        pool, preds = self._pool_of(generated[i], size)
        pools[i].append(pool)
        logits[i].append(preds)
        rmse[i].append(None if batch_rmse[i] is None
                       else batch_rmse[i].cpu().numpy())
    return self._trim(pools), self._trim(logits), self._trim(rmse)

  def calculate_fid_score(self, generator: Callable):
    """Returns (fid, fid_std, rmse, inception_score) dicts keyed by frame
    index 1..T-1; `generator` maps the conditions dict to the 7-list.
    Every rank calls it with the same generator; rank 0 computes the
    scores, every rank returns them."""
    fid_list = {i: [] for i in range(1, self.eval_seq_len)}
    rmse_list = {i: [] for i in range(1, self.eval_seq_len)}
    is_list = {i: [] for i in range(1, self.eval_seq_len)}
    log.info('Calculate Generator Statistics')
    for _ in range(self.avg_num):
      generated_pool, logits, rmse_total = (
          self._get_generated_pool_for_evaluation(generator))
      if not self.data.is_chief:
        continue
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
    return self.data.broadcast((fid, fid_std, rmse, inception_score))
