"""Z-buffer point splatting (port of `se3ds_tpu.ops.splat`, the exact
'scatter' mode and the 'fast' mode).

Semantics follow the JAX package: points map to pixels by a perspective
divide and truncation toward zero; invalid points (out of bounds, depth
<= 0, or any feature channel equal to the void value) are dropped. Both
modes keep the exact f32 minimum depth per pixel. The exact splat then
takes, per channel, the maximum feature over the points whose raw depth
is within 0.1 m of that minimum; the 'fast' splat keeps the largest u32
key `(255 - 8-bit depth bucket) << 24 | feature bytes`.

On CUDA tensors each splat runs its hand-written kernel
(`splat_cuda.splat_exact`, `splat_cuda.splat_fast`); on CPU tensors its
plain PyTorch version.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Points deeper than (min depth + tolerance) at a pixel are left out of
# the exact splat's feature max; the sum is taken in float32, as JAX adds
# its weak-typed 0.1 to a float32 depth.
DEPTH_COLLISION_TOLERANCE = 0.1


def _normalize_view_coords(coords: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Perspective-divides xy by z with divide-no-nan semantics.

  Args:
    coords: (N, 4, M) homogeneous point coordinates.

  Returns:
    view: (N, 2, M) xy divided by depth (0 where depth == 0).
    depth: (N, M) the raw z coordinate.
  """
  depth = coords[:, 2, :]
  safe = torch.where(depth == 0, torch.ones_like(depth), depth)
  view = torch.where(depth[:, None, :] == 0, torch.zeros_like(coords[:, 0:2]),
                     coords[:, 0:2, :] / safe[:, None, :])
  return view, depth


def _truncated_index(f: torch.Tensor, size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Truncates toward zero (NaN -> 0) and tests 0 <= index < size.

  The bounds test runs in float, so values out of the int32 range are
  invalid, as after the JAX package's saturating float->int32 cast.
  """
  t = torch.trunc(torch.nan_to_num(f, nan=0.0))
  ok = (t >= 0) & (t < size)
  return torch.where(ok, t, torch.zeros_like(t)).to(torch.int64), ok


def pixel_coords(transformed_coords: torch.Tensor, feats: torch.Tensor,
                 height: int, width: int, input_void_class: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Per-point pixel mapping and validity (JAX `splat.pixel_coords`).

  Args:
    transformed_coords: (N, 4, M) pose-relative homogeneous coordinates.
    feats: (N, M, C) feature values.

  Returns:
    flat: (N, M) int64 flat pixel index, height*width for invalid points.
    depth: (N, M) raw z depth.
    valid: (N, M) bool validity.
  """
  view, depth = _normalize_view_coords(transformed_coords)
  px, ok_x = _truncated_index((view[:, 0, :] + 1.0) / 2.0 * width, width)
  py, ok_y = _truncated_index((view[:, 1, :] + 1.0) / 2.0 * height, height)
  valid = ok_x & ok_y & (depth > 0) & torch.all(feats != input_void_class,
                                                dim=-1)
  flat = torch.where(valid, py * width + px,
                     torch.full_like(px, height * width))
  return flat, depth, valid


def packed_keys(depth: torch.Tensor, feats: torch.Tensor,
                depth_scale: float) -> torch.Tensor:
  """(N, M) int64 holding the u32 key of every point.

  `(255 - clip(depth / depth_scale * 255)) << 24 | feature bytes`, with
  channel 0 in the highest byte below the depth bucket.
  """
  # A 0-dim tensor divisor on depth's device: PyTorch's CUDA division by a
  # Python scalar multiplies by its reciprocal instead, which can move a
  # point into the next depth bucket.
  scale = torch.full((), depth_scale, dtype=depth.dtype, device=depth.device)
  qdepth = torch.clamp(depth / scale * 255.0, 0.0, 255.0)
  key = (255 - torch.nan_to_num(qdepth, nan=0.0).to(torch.int64)) << 24
  fbytes = torch.clamp(torch.nan_to_num(feats, nan=0.0), 0.0, 255.0).to(
      torch.int64)
  channels = feats.shape[-1]
  for c in range(channels):
    key = key | (fbytes[..., c] << (8 * (channels - 1 - c)))
  return key


def project_to_feat(
    transformed_coords: torch.Tensor,
    feats: torch.Tensor,
    height: int,
    width: int,
    depth_scale: float,
    input_void_class: float,
    output_void_class: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Exact z-buffer splat (JAX `splat.project_to_feat`, 'scatter' mode).

  Per pixel: the minimum depth of the valid points (clipped to
  depth_scale), then the per-channel maximum of the features of the
  points whose RAW depth is < that minimum + 0.1 (in float32), taken
  against output_void_class. Channels mix: points (10, 200, 7) and
  (200, 10, 7) in one window give (200, 200, 7). Any number of channels
  and any finite float features.

  Args:
    transformed_coords: (N, 4, M) of (x, y, z, 1); z is depth.
    feats: (N, M) or (N, M, C) feature values.
    height, width: Output image size in pixels.
    depth_scale: Maximum depth in metres; deeper values are clipped.
    input_void_class: Feature value marking an invalid input point.
    output_void_class: Fill value for pixels receiving no points.

  Returns:
    projected_depth: (N, H, W) depth in [0, 1].
    projected_feat: (N, H, W) or (N, H, W, C) feature image.
  """
  from se3ds_torch.ops import splat_cuda  # it imports this module

  if feats.dim() not in (2, 3):
    raise ValueError(
        f'feats should have shape (N, M) or (N, M, C), got {feats.shape}')
  is_scalar_feat = feats.dim() == 2
  if is_scalar_feat:
    feats = feats[..., None]
  dtype = transformed_coords.dtype
  batch_size, channels = transformed_coords.shape[0], feats.shape[-1]
  zbuf, fbuf = splat_cuda.splat_exact(
      transformed_coords, feats.to(dtype), height, width, depth_scale,
      input_void_class, output_void_class)
  # A 0-dim divisor divides exactly on the card too (see packed_keys).
  scale = torch.full((), depth_scale, dtype=zbuf.dtype, device=zbuf.device)
  projected_depth = (torch.clamp(zbuf, 0.0, depth_scale) / scale).reshape(
      batch_size, height, width).to(dtype)
  projected_feat = fbuf.to(dtype).reshape(batch_size, height, width, channels)
  if is_scalar_feat:
    projected_feat = projected_feat[..., 0]
  return projected_depth, projected_feat


def project_to_feat_fast(
    transformed_coords: torch.Tensor,
    feats: torch.Tensor,
    height: int,
    width: int,
    depth_scale: float,
    input_void_class: float,
    output_void_class: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Packed single-pass z-buffer splat (JAX `splat.project_to_feat_fast`).

  The winner at each pixel is the point in the shallowest depth_scale/256
  bucket with the lexicographically largest feature bytes; the depth
  output is the exact minimum depth. Feature values must be integers in
  [0, 255] (RGB and semantic classes are).

  Args:
    transformed_coords: (N, 4, M) of (x, y, z, 1); z is depth.
    feats: (N, M) or (N, M, C) feature values, C <= 3.
    height, width: Output image size in pixels.
    depth_scale: Maximum depth in metres.
    input_void_class: Feature value marking an invalid input point.
    output_void_class: Fill value for pixels receiving no points.

  Returns:
    projected_depth: (N, H, W) depth in [0, 1].
    projected_feat: (N, H, W) or (N, H, W, C) feature image.
  """
  from se3ds_torch.ops import splat_cuda  # it imports this module

  if feats.dim() not in (2, 3):
    raise ValueError(
        f'feats should have shape (N, M) or (N, M, C), got {feats.shape}')
  is_scalar_feat = feats.dim() == 2
  if is_scalar_feat:
    feats = feats[..., None]
  channels = feats.shape[-1]
  if channels > 3:
    raise NotImplementedError(
        'project_to_feat_fast packs at most 3 feature bytes; the JAX '
        'package falls back to the exact splat here, the port raises: '
        'call project_to_feat.')
  dtype = transformed_coords.dtype
  feats = feats.to(dtype)
  batch_size = transformed_coords.shape[0]

  zbuf, pbuf = splat_cuda.splat_fast(transformed_coords, feats, height,
                                     width, depth_scale, input_void_class)
  projected_depth = (torch.clamp(zbuf, 0.0, depth_scale) / depth_scale
                     ).reshape(batch_size, height, width)
  got_point = pbuf != 0
  void = torch.full((), output_void_class, dtype=dtype, device=pbuf.device)
  cols = [torch.where(got_point,
                      ((pbuf >> (8 * (channels - 1 - c))) & 0xFF).to(dtype),
                      void)
          for c in range(channels)]
  projected_feat = torch.stack(cols, dim=-1).reshape(
      batch_size, height, width, channels)
  if is_scalar_feat:
    projected_feat = projected_feat[..., 0]
  return projected_depth, projected_feat
