"""Equirectangular panorama geometry (port of `se3ds_tpu.ops.geometry`).

The serving and eval subset: point-cloud unprojection at `size_mult=1`,
the equirectangular view coordinates, the splat dispatch (with
`project_memory_equirect`, the memory splat at a camera offset that the
kernels fuse with the view coordinates), the pole mask and the pole
crop.
Conventions follow the JAX package: world z up toward the pano's north
pole, heading measured from the x-axis toward the y-axis.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from se3ds_torch import device as device_lib
from se3ds_torch.ops import splat

# The exact modes are bit-identical in the JAX package ('scatter' is its
# definition); the port runs all three as `splat.project_to_feat`. 'fast'
# and 'pallas' share the packed-key semantics. 'sorted_packed',
# 'fast_exact' and 'dual_sorted' are not ported yet.
EXACT_SPLAT_MODES = ('scatter', 'sorted', 'pallas_exact')
SPLAT_MODES = EXACT_SPLAT_MODES + ('fast', 'pallas')


def equirect_view_coords(xyz1: torch.Tensor) -> torch.Tensor:
  """Maps (N, 4, M) world points to equirect synthetic view coordinates.

  xyz -> (heading, elevation, radius) -> image-plane coordinates whose
  perspective divide lands on pano pixels.
  """
  dtype = xyz1.dtype
  x, y, z = xyz1[:, 0, :], xyz1[:, 1, :], xyz1[:, 2, :]
  rad = torch.sqrt(x * x + y * y + z * z)
  # Heading from the x-axis rotating left, re-based to the left edge of the
  # pano rotating right, wrapped into (0, 2*pi].
  heading = torch.atan2(y, x)
  heading = 1.5 * math.pi - heading
  heading = heading + (2 * math.pi) * (heading <= 0).to(dtype)
  heading = heading - (2 * math.pi) * (heading > (2 * math.pi)).to(dtype)
  # divide_no_nan: elevation of the origin point maps to acos(0) = pi/2.
  zero = rad == 0
  cos_elev = torch.where(zero, torch.zeros_like(z),
                         z / torch.where(zero, torch.ones_like(rad), rad))
  elevation = torch.arccos(torch.clamp(cos_elev, -1.0, 1.0))

  # 0-dim divisors divide exactly on the card too (device.divisor).
  proj_x = rad * ((heading / device_lib.divisor(2 * math.pi, heading)) * 2
                  - 1)
  proj_y = rad * ((elevation / device_lib.divisor(math.pi, elevation)) * 2
                  - 1)
  return torch.stack([proj_x, proj_y, rad, torch.ones_like(proj_x)],
                     dim=1).to(dtype)


def _is_exact(splat_mode: Optional[str]) -> bool:
  """Whether `splat_mode` runs the exact splat; raises on unported modes."""
  if splat_mode is None:
    splat_mode = 'scatter'
  if splat_mode not in SPLAT_MODES:
    raise NotImplementedError(
        f'splat_mode={splat_mode!r} is not ported yet (ROADMAP.md item '
        f'A10); the port runs {SPLAT_MODES}.')
  return splat_mode in EXACT_SPLAT_MODES


def project_feats_to_equirectangular(
    feats: torch.Tensor,
    xyz1: torch.Tensor,
    height: int,
    width: int,
    void_class: float,
    depth_scale: float,
    splat_mode: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Projects point-cloud features into an equirectangular image.

  This is `project_memory_equirect` at a zero offset: on CUDA tensors the
  kernels compute the view coordinates; on CPU tensors the plain path,
  `equirect_view_coords` then the splat's plain version (x - 0 == x).

  Args:
    feats: (N, M) or (N, M, C) point features.
    xyz1: (N, 4, M) homogeneous point coordinates.
    height, width: Output pano size in pixels.
    void_class: Feature value marking an empty point.
    depth_scale: Maximum depth in metres.
    splat_mode: None (the JAX default) or one of the exact modes
      'scatter', 'sorted' and 'pallas_exact' (on the card the exact CUDA
      kernel), or 'fast' or 'pallas' (on the card the 'fast' CUDA kernel).

  Returns:
    reprojected_depth: (N, H, W) depth in [0, 1].
    reprojected_feats: (N, H, W[, C]) feature image.
  """
  offset = torch.zeros((1, 4), dtype=xyz1.dtype, device=xyz1.device)
  return project_memory_equirect(feats, xyz1, offset, height, width,
                                 void_class, depth_scale, splat_mode)


def project_memory_equirect(
    feats: torch.Tensor,
    xyz1: torch.Tensor,
    offset: torch.Tensor,
    height: int,
    width: int,
    void_class: float,
    depth_scale: float,
    splat_mode: Optional[str] = None,
    need_depth: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
  """The memory's equirect guidance seen from a camera at `offset`.

  On CUDA tensors the splat kernels read the world points and the offset
  and compute the view coordinates in registers (`splat.splat_images`):
  no translated copy or view tensor is written. CPU tensors take
  `project_memory_equirect_plain`.

  Args:
    feats, height, width, void_class, depth_scale, splat_mode: as
      `project_feats_to_equirectangular`.
    xyz1: (N, 4, M) world points (any row and batch stride, e.g. a slice
      of the memory).
    offset: (N, 4) or (1, 4) camera positions, homogeneous w = 0.
    need_depth: False returns None for the depth (the 'fast' kernel then
      skips the depth atomics).

  Returns:
    reprojected_depth: (N, H, W) depth in [0, 1], or None.
    reprojected_feats: (N, H, W[, C]) feature image.
  """
  exact = _is_exact(splat_mode)
  if xyz1.is_cuda:
    return splat.splat_images(exact, xyz1, feats, height, width, depth_scale,
                              void_class, offset=offset,
                              need_depth=need_depth)
  depth, feat = project_memory_equirect_plain(
      feats, xyz1, offset, height, width, void_class, depth_scale,
      splat_mode)
  return (depth if need_depth else None), feat


def project_memory_equirect_plain(
    feats: torch.Tensor,
    xyz1: torch.Tensor,
    offset: torch.Tensor,
    height: int,
    width: int,
    void_class: float,
    depth_scale: float,
    splat_mode: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of `project_memory_equirect` on any device:
  the translated copy `xyz1 - offset`, `equirect_view_coords` and the
  splat's plain version (what the CPU runs)."""
  splat_fn = (splat.project_to_feat_plain if _is_exact(splat_mode)
              else splat.project_to_feat_fast_plain)
  return splat_fn(equirect_view_coords(xyz1 - offset[..., None]),
                  feats.to(xyz1.dtype), height, width,
                  depth_scale=depth_scale, input_void_class=void_class)


def _linspace_f32(start: float, stop: float, num: int,
                  device: torch.device) -> torch.Tensor:
  """float32 linspace with the same bits as `jnp.linspace` (f32 default).

  jnp.linspace computes `start * (1 - t) + stop * t` with `t = i / (num -
  1)` in float32 and sets the last element to `stop` exactly.
  """
  start32, stop32 = np.float32(start), np.float32(stop)
  if num == 1:
    out = np.array([start32], np.float32)
  else:
    t = np.arange(num, dtype=np.float32) / np.float32(num - 1)
    out = (start32 * (np.float32(1) - t) + stop32 * t).astype(np.float32)
    out[-1] = stop32
  return torch.from_numpy(out).to(device)


def equirectangular_to_pointcloud(
    feats: torch.Tensor,
    depth: torch.Tensor,
    void_class: float,
    depth_scale: float,
    size_mult: float = 1.0,
    interpolation_method: str = 'nearest',
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Unprojects an equirectangular RGB-D image into a point cloud.

  All H*W points are returned; points with invalid depth get feature value
  `void_class` and coordinate (0, 0, 0, 1), so the splat skips them.

  Args:
    feats: (N, H, W) or (N, H, W, C) features.
    depth: (N, H, W) depth in [0, 1].
    void_class: Feature value assigned to invalid points.
    depth_scale: Maximum depth in metres.
    size_mult: Must be 1 (resampling waits for ops/image.py, ROADMAP A10).
    interpolation_method: 'nearest' or 'bilinear'. At size_mult=1 bilinear
      only casts the features to float32, as the JAX package does.

  Returns:
    xyz1: (N, 4, H*W) homogeneous coordinates.
    filtered_feats: (N, H*W[, C]) features.
  """
  if feats.dim() not in (3, 4):
    raise ValueError('feats should have shape (N, H, W) or (N, H, W, C),'
                     f' got {tuple(feats.shape)} instead.')
  if size_mult != 1.0:
    raise NotImplementedError(
        'equirectangular_to_pointcloud resamples only at size_mult=1; the '
        'resize path (ops/image.py) is ROADMAP item A10.')
  if interpolation_method not in ('nearest', 'bilinear'):
    raise ValueError(f'unknown interpolation_method {interpolation_method!r}')
  is_scalar_feat = feats.dim() == 3
  if is_scalar_feat:
    feats = feats[..., None]
  batch_size, height, width, channels = feats.shape
  if width != 2 * height:
    raise ValueError('Expected equirectangular input images')
  dtype = depth.dtype
  if interpolation_method != 'nearest':
    feats = feats.to(torch.float32)

  half_pixel_width = 0.5 * math.pi / height
  elevation = _linspace_f32(half_pixel_width, math.pi - half_pixel_width,
                            height, depth.device).to(dtype)
  # Heading from the x-axis, increasing toward the y-axis.
  heading = _linspace_f32(1.5 * math.pi - half_pixel_width,
                          -0.5 * math.pi + half_pixel_width, width,
                          depth.device).to(dtype)
  depth_mask = ((depth > 0) & (depth < 1.0)).to(dtype)
  rad = (depth * depth_scale) * depth_mask
  feats = torch.where(depth_mask[..., None] == 0,
                      torch.full((), void_class, dtype=feats.dtype,
                                 device=feats.device), feats)

  sin_elev = torch.sin(elevation)[:, None]
  x = rad * sin_elev * torch.cos(heading)[None, :]
  y = rad * sin_elev * torch.sin(heading)[None, :]
  z = rad * torch.cos(elevation)[:, None]
  xyz1 = torch.stack([
      x.reshape(batch_size, -1),
      y.reshape(batch_size, -1),
      z.reshape(batch_size, -1),
      torch.ones((batch_size, height * width), dtype=dtype,
                 device=depth.device),
  ], dim=1)
  filtered_feats = feats.reshape(batch_size, -1, channels)
  if is_scalar_feat:
    filtered_feats = filtered_feats[..., 0]
  return xyz1, filtered_feats


def mask_pano(pano: torch.Tensor, proportion: float = 0.125,
              masked_region_value=0) -> torch.Tensor:
  """Blanks the top/bottom `proportion` rows of (N, H, W, C) panos."""
  height = pano.shape[1]
  masked_height = int(height * proportion)
  rows = torch.arange(height, device=pano.device)
  mask = (rows >= masked_height) & (rows <= height - masked_height)
  mask = mask.to(pano.dtype)[None, :, None, None]
  return mask * pano + (1 - mask) * masked_region_value


def crop_pano(pano: torch.Tensor, proportion: float = 0.125,
              resize_to_original: bool = False) -> torch.Tensor:
  """Crops away the top/bottom `proportion` rows of (N, H, W, C) or
  (H, W, C) panos (JAX `geometry.crop_pano`)."""
  if pano.dim() not in (3, 4):
    raise ValueError(f'pano should be of shape (N, H, W, C), got '
                     f'{tuple(pano.shape)} instead.')
  if resize_to_original:
    raise NotImplementedError(
        'crop_pano(resize_to_original=True) resizes with ops/image.py, '
        'which is not ported yet (ROADMAP.md item A10).')
  row_axis = pano.dim() - 3
  height = pano.shape[row_axis]
  masked_height = int(height * proportion)
  return pano.narrow(row_axis, masked_height, height - 2 * masked_height)
