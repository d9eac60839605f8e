"""Misc math utilities (port of `se3ds_tpu.utils.math_utils`).

The colormaps stay numpy; the metrics and the inpainting run on the
caller's tensors' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def create_label_colormap() -> np.ndarray:
  """Bit-shift label colormap for up to 256 labels."""
  colormap = np.zeros((256, 3), dtype=int)
  ind = np.arange(256, dtype=int)
  for shift in reversed(range(8)):
    for channel in range(3):
      colormap[:, channel] |= ((ind >> channel) & 1) << shift
    ind >>= 3
  return colormap


def cmap_to_label(image_tensor, cmap) -> np.ndarray:
  """Inverse of create_label_colormap."""
  rgb_equal = np.all(np.asarray(image_tensor)[..., None, :] == cmap, axis=-1)
  return np.argmax(rgb_equal, axis=-1)


def compute_kl(mu1: torch.Tensor, logvar1: torch.Tensor, mu2: torch.Tensor,
               logvar2: torch.Tensor) -> torch.Tensor:
  """KL(P||Q) for diagonal Gaussians."""
  if not mu1.shape == logvar1.shape == mu2.shape == logvar2.shape:
    raise ValueError('Arguments to compute KLD should have the same shape.')
  sigma1 = torch.exp(0.5 * logvar1)
  sigma2 = torch.exp(0.5 * logvar2)
  return (torch.log(sigma2 / sigma1)
          + (torch.exp(logvar1) + (mu1 - mu2)**2) / (2 * torch.exp(logvar2))
          - 0.5)


def reparameterize(generator: torch.Generator, mu: torch.Tensor,
                   logvar: torch.Tensor) -> torch.Tensor:
  """Reparameterisation trick: eps * exp(logvar / 2) + mu, with eps drawn
  from `generator` (on the tensors' device)."""
  sigma = torch.exp(0.5 * logvar)
  eps = torch.randn(sigma.shape, generator=generator, dtype=mu.dtype,
                    device=mu.device)
  return eps * sigma + mu


def _divide_no_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  zero = b == 0
  return torch.where(zero, 0.0, a / torch.where(zero, 1, b))


def compute_sequence_iou(one_hot_pred: torch.Tensor, one_hot_true:
                         torch.Tensor, mask: torch.Tensor,
                         spatial_mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Masked per-frame mIoU over (N, T, H, W, C) one-hots: ((N, T) IoU,
  the mean over valid frames and examples)."""
  if spatial_mask is None:
    spatial_mask = torch.ones_like(one_hot_pred)[..., 0]
  intersect = torch.sum(
      one_hot_pred * one_hot_true * spatial_mask[..., None], dim=(2, 3, 4))
  union = torch.sum((one_hot_pred + one_hot_true) * spatial_mask[..., None],
                    dim=(2, 3, 4)) - intersect
  seq_iou = _divide_no_nan(intersect * mask, union * mask)
  mask_length = torch.sum(mask, dim=1)
  mean_iou = _divide_no_nan(torch.sum(seq_iou, dim=1), mask_length)
  return seq_iou, torch.mean(mean_iou)


def compute_sequence_accuracy(class_pred: torch.Tensor,
                              class_gt: torch.Tensor, mask: torch.Tensor,
                              spatial_mask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Masked per-frame accuracy over (N, T, H, W) labels: ((N, T)
  accuracy, the mean over valid frames and examples)."""
  if spatial_mask is None:
    spatial_mask = torch.ones_like(class_pred)
  equal = (class_pred == class_gt).to(spatial_mask.dtype) * spatial_mask
  seq_accuracy = _divide_no_nan(
      torch.sum(equal, dim=(2, 3)).float(),
      torch.sum(spatial_mask, dim=(2, 3)).float())
  mask_length = torch.sum(mask, dim=1)
  mean_accuracy = _divide_no_nan(torch.sum(seq_accuracy, dim=1), mask_length)
  return seq_accuracy, torch.mean(mean_accuracy)


def nearest_neighbor_inpaint(image: torch.Tensor,
                             void_class: int = 0) -> torch.Tensor:
  """Fills the void pixels of (N, H, W) images with the value of the
  nearest non-void pixel (squared distance; ties go to the first pixel
  in raster order, as `jnp.argmin` breaks them).

  The JAX package's static-shape formulation: for every pixel, the argmin
  over all non-void pixels of a (P, P) distance table, P = H * W.
  """
  _, h, w = image.shape
  ys, xs = torch.meshgrid(torch.arange(h, device=image.device),
                          torch.arange(w, device=image.device),
                          indexing='ij')
  ys, xs = ys.reshape(-1).float(), xs.reshape(-1).float()
  # Integer distances, exact in float32 below 2**24.
  d2 = (ys[:, None] - ys[None, :])**2 + (xs[:, None] - xs[None, :])**2
  out = []
  for img in image:
    flat = img.reshape(-1)
    nonzero = flat != void_class
    # Rows are sources: a void source is never the nearest.
    closest = torch.argmin(d2.masked_fill(~nonzero[:, None], float('inf')),
                           dim=0)
    out.append(torch.where(nonzero, flat, flat[closest]).reshape(h, w))
  return torch.stack(out)


def get_local_ckpt_path(ckpt_path: str) -> str:
  """Copies a checkpoint to the working directory."""
  import glob
  import os
  import shutil
  glob_path = ckpt_path + '*'
  if os.path.isdir(ckpt_path):
    glob_path = os.path.join(ckpt_path, '*')
  for path in glob.glob(glob_path):
    local_path = path.split('/')[-1]
    if not os.path.exists(local_path):
      if os.path.isdir(path):
        shutil.copytree(path, local_path)
      else:
        shutil.copy(path, local_path)
  return ckpt_path.split('/')[-1]
