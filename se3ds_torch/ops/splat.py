"""Z-buffer point splatting (port of `se3ds_tpu.ops.splat`, the exact
'scatter' mode and the 'fast' mode).

Semantics follow the JAX package: points map to pixels by a perspective
divide and truncation toward zero; invalid points (out of bounds, depth
<= 0, or any feature channel equal to the void value) are dropped. Both
modes keep the exact f32 minimum depth per pixel. The exact splat then
takes, per channel, the maximum feature over the points whose raw depth
is within 0.1 m of that minimum; the 'fast' splat keeps the largest u32
key `(255 - 8-bit depth bucket) << 24 | feature bytes`.

On CUDA tensors each splat runs its hand-written kernels (`splat_images`,
over `splat_cuda`); on CPU tensors its plain PyTorch version
(`project_to_feat_plain`, `project_to_feat_fast_plain`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from se3ds_torch import device as device_lib

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
  # An exact divide on the card too (`device.divisor`): a multiply by the
  # reciprocal can move a point into the next depth bucket.
  qdepth = torch.clamp(
      depth / device_lib.divisor(depth_scale, depth) * 255.0, 0.0, 255.0)
  key = (255 - torch.nan_to_num(qdepth, nan=0.0).to(torch.int64)) << 24
  fbytes = torch.clamp(torch.nan_to_num(feats, nan=0.0), 0.0, 255.0).to(
      torch.int64)
  channels = feats.shape[-1]
  for c in range(channels):
    key = key | (fbytes[..., c] << (8 * (channels - 1 - c)))
  return key


def _feats_3d(feats: torch.Tensor) -> Tuple[torch.Tensor, bool]:
  """(N, M, C) features and whether they came as scalar (N, M)."""
  if feats.dim() not in (2, 3):
    raise ValueError(
        f'feats should have shape (N, M) or (N, M, C), got {feats.shape}')
  return (feats[..., None], True) if feats.dim() == 2 else (feats, False)


def _check_fast_channels(channels: int) -> None:
  if channels > 3:
    raise NotImplementedError(
        'project_to_feat_fast packs at most 3 feature bytes; the JAX '
        'package falls back to the exact splat here, the port raises: '
        'call project_to_feat.')


def splat_images(exact: bool, points: torch.Tensor, feats: torch.Tensor,
                 height: int, width: int, depth_scale: float,
                 input_void_class: float, output_void_class: float = 0.0,
                 offset: Optional[torch.Tensor] = None,
                 need_depth: bool = True
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
  """A splat's two images from its CUDA kernels (CUDA tensors only).

  The exact (`exact=True`) or 'fast' point pass, then its resolve, with
  the outputs of `project_to_feat` / `project_to_feat_fast`.

  Args:
    points: (N, 4, M) view coordinates, or world points when `offset`, an
      (N, 4) or (1, 4) camera position, is given (the kernels then take
      the equirect view of `points - offset` in registers).
    feats: (N, M) or (N, M, C) feature values.
    need_depth: False returns None for the depth (the 'fast' kernel then
      skips its depth atomics).

  Returns:
    projected_depth: (N, H, W) depth in [0, 1], or None.
    projected_feat: (N, H, W) or (N, H, W, C) feature image.
  """
  from se3ds_torch.ops import splat_cuda  # it imports this module

  feats, is_scalar_feat = _feats_3d(feats)
  batch_size, channels = points.shape[0], feats.shape[-1]
  feats = feats.to(points.dtype)
  if exact:
    depth, feat = splat_cuda.exact_resolve(
        splat_cuda.exact_words(points, feats, height, width, depth_scale,
                               input_void_class, offset=offset),
        depth_scale, output_void_class, need_depth=need_depth)
  else:
    _check_fast_channels(channels)
    depth, feat = splat_cuda.fast_resolve(
        splat_cuda.fast_words(points, feats, height, width, depth_scale,
                              input_void_class, offset=offset,
                              need_depth=need_depth),
        channels, depth_scale, output_void_class)
  if depth is not None:
    depth = depth.reshape(batch_size, height, width)
  feat = feat.reshape(batch_size, height, width, channels)
  return depth, feat[..., 0] if is_scalar_feat else feat


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

  CUDA tensors run the exact kernel (`splat_images`); CPU tensors
  `project_to_feat_plain`.

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
  if transformed_coords.is_cuda:
    return splat_images(True, transformed_coords, feats, height, width,
                        depth_scale, input_void_class, output_void_class)
  return project_to_feat_plain(transformed_coords, feats, height, width,
                               depth_scale, input_void_class,
                               output_void_class)


def project_to_feat_plain(transformed_coords, feats, height, width,
                          depth_scale, input_void_class,
                          output_void_class=0.0):
  """Plain PyTorch version of `project_to_feat` (any device)."""
  from se3ds_torch.ops import splat_cuda  # it imports this module

  feats, is_scalar_feat = _feats_3d(feats)
  dtype = transformed_coords.dtype
  batch_size, channels = transformed_coords.shape[0], feats.shape[-1]
  zbuf, fbuf = splat_cuda.splat_exact_plain(
      transformed_coords, feats.to(dtype), height, width, depth_scale,
      input_void_class, output_void_class)
  projected_depth = (torch.clamp(zbuf, 0.0, depth_scale)
                     / device_lib.divisor(depth_scale, zbuf)).reshape(
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

  CUDA tensors run the 'fast' kernel (`splat_images`); CPU tensors
  `project_to_feat_fast_plain`.

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
  if transformed_coords.is_cuda:
    return splat_images(False, transformed_coords, feats, height, width,
                        depth_scale, input_void_class, output_void_class)
  return project_to_feat_fast_plain(transformed_coords, feats, height, width,
                                    depth_scale, input_void_class,
                                    output_void_class)


def project_to_feat_fast_plain(transformed_coords, feats, height, width,
                               depth_scale, input_void_class,
                               output_void_class=0.0):
  """Plain PyTorch version of `project_to_feat_fast` (any device)."""
  from se3ds_torch.ops import splat_cuda  # it imports this module

  feats, is_scalar_feat = _feats_3d(feats)
  channels = feats.shape[-1]
  _check_fast_channels(channels)
  dtype = transformed_coords.dtype
  feats = feats.to(dtype)
  batch_size = transformed_coords.shape[0]

  zbuf, pbuf = splat_cuda.splat_fast_plain(transformed_coords, feats, height,
                                           width, depth_scale,
                                           input_void_class)
  projected_depth = (torch.clamp(zbuf, 0.0, depth_scale)
                     / device_lib.divisor(depth_scale, zbuf)).reshape(
                         batch_size, height, width)
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
