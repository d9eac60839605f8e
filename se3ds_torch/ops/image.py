"""Image resampling with TF-compatible semantics (port of
`se3ds_tpu.ops.image`).

`resize` follows `tf.image.resize` v2 as `jax.image.resize` computes it:
half-pixel centres, per-axis weight matrices built from the kernel
(triangle for linear, Keys cubic with a = -0.5 for cubic) and normalised
to sum to one, widened by the scale when antialiasing a downsample.
`F.interpolate` differs on cubic (a = -0.75, clamped borders), so every
method goes through the weight matrices here. `interpolate_bilinear`
follows `tensorflow_addons.image.interpolate_bilinear`, which the
reference uses to rotate and warp panoramas (pano_utils.py:339,412,472).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch


@contextlib.contextmanager
def _full_float32(device: torch.device):
  """float32 matmuls without TF32 on the card (the JAX package runs these
  products at `Precision.HIGHEST`); a no-op on the CPU."""
  if device.type != 'cuda':
    yield
    return
  saved = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved


def _triangle(x: torch.Tensor) -> torch.Tensor:
  return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
  out = ((1.5 * x - 2.5) * x) * x + 1.
  out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
  return torch.where(x >= 2., torch.zeros_like(x), out)


_KERNELS = {'linear': _triangle, 'bilinear': _triangle, 'cubic': _keys_cubic,
            'bicubic': _keys_cubic}


def _weight_matrix(in_size: int, out_size: int, kernel, antialias: bool,
                   device: torch.device) -> torch.Tensor:
  """(in_size, out_size) float32 resampling weights (jax.image's
  `compute_weight_mat` at translation 0)."""
  inv_scale = 1. / (out_size / in_size)
  kernel_scale = max(inv_scale, 1.) if antialias else 1.
  f32 = dict(dtype=torch.float32, device=device)
  sample_f = ((torch.arange(out_size, **f32) + 0.5)
              * torch.tensor(inv_scale, **f32) - 0.5)
  x = torch.abs(sample_f[None, :] - torch.arange(in_size, **f32)[:, None]
                ) / torch.tensor(kernel_scale, **f32)
  weights = kernel(x)
  total = torch.sum(weights, dim=0, keepdim=True)
  weights = torch.where(
      torch.abs(total) > 1000. * float(np.finfo(np.float32).eps),
      weights / torch.where(total != 0, total, torch.ones_like(total)),
      torch.zeros_like(weights))
  inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
  return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _nearest_indices(in_size: int, out_size: int,
                     device: torch.device) -> torch.Tensor:
  """jax.image's nearest source index, floor((i + 0.5) * in / out) in
  float32."""
  offsets = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
             * np.float32(in_size) / np.float32(out_size))
  return torch.from_numpy(np.floor(offsets).astype(np.int64)).to(device)


def resize(images: torch.Tensor, size: Tuple[int, int],
           method: str = 'bilinear', antialias: bool = False
           ) -> torch.Tensor:
  """Resizes (..., H, W, C) images to `size` with TF v2 conventions.

  Linear and cubic return float32; nearest keeps the input dtype.
  """
  if method != 'nearest' and method not in _KERNELS:
    raise ValueError(f'Unsupported resize method: {method}')
  height, width = images.shape[-3], images.shape[-2]
  out_h, out_w = int(size[0]), int(size[1])
  if method == 'nearest':
    if out_h != height:
      images = images.index_select(
          -3, _nearest_indices(height, out_h, images.device))
    if out_w != width:
      images = images.index_select(
          -2, _nearest_indices(width, out_w, images.device))
    return images
  kernel = _KERNELS[method]
  out = images.to(torch.float32)
  with _full_float32(out.device):
    if out_h != height:
      weights = _weight_matrix(height, out_h, kernel, antialias, out.device)
      out = torch.einsum('...hwc,ho->...owc', out, weights)
    if out_w != width:
      weights = _weight_matrix(width, out_w, kernel, antialias, out.device)
      out = torch.einsum('...hwc,wo->...hoc', out, weights)
  return out


def interpolate_bilinear(grid: torch.Tensor, query_points: torch.Tensor,
                         indexing: str = 'ij') -> torch.Tensor:
  """Samples `grid` at float `query_points` with bilinear interpolation.

  As tensorflow_addons' `interpolate_bilinear`: the floor of each
  coordinate is clamped to [0, size - 2] and its fraction to [0, 1], so
  the 4-neighbourhood stays in bounds.

  Args:
    grid: (N, H, W, C) image.
    query_points: (N, P, 2) float coordinates; (y, x) for indexing='ij',
      (x, y) for indexing='xy'.
    indexing: 'ij' or 'xy'.

  Returns:
    (N, P, C) float32 interpolated values.
  """
  if indexing not in ('ij', 'xy'):
    raise ValueError("indexing must be 'ij' or 'xy'")
  n, height, width, channels = grid.shape
  grid = grid.to(torch.float32)
  query_points = query_points.to(torch.float32)
  if indexing == 'ij':
    qy, qx = query_points[..., 0], query_points[..., 1]
  else:
    qx, qy = query_points[..., 0], query_points[..., 1]

  def axis_coords(q, size):
    floor = torch.clamp(torch.floor(q), 0.0, size - 2)
    alpha = torch.clamp(q - floor, 0.0, 1.0)
    return floor.to(torch.int64), alpha

  y0, ay = axis_coords(qy, height)
  x0, ax = axis_coords(qx, width)
  flat = grid.reshape(n, height * width, channels)

  def gather(yi, xi):
    idx = (yi * width + xi)[..., None].expand(-1, -1, channels)
    return torch.gather(flat, 1, idx)

  top_left = gather(y0, x0)
  top_right = gather(y0, x0 + 1)
  bottom_left = gather(y0 + 1, x0)
  bottom_right = gather(y0 + 1, x0 + 1)
  ax = ax[..., None]
  ay = ay[..., None]
  top = top_left + (top_right - top_left) * ax
  bottom = bottom_left + (bottom_right - bottom_left) * ax
  return top + (bottom - top) * ay
