"""Z-buffer point splatting (port of `se3ds_tpu.ops.splat`: every mode).

Semantics follow the JAX package: points map to pixels by a perspective
divide and truncation toward zero; invalid points (out of bounds, depth
<= 0, or any feature channel equal to the void value) are dropped. Every
mode keeps the exact f32 minimum depth per pixel. The modes then pick
the features:

* exact ('scatter', `project_to_feat`): per channel, the maximum feature
  over the points whose raw depth is within 0.1 m of that minimum;
* 'fast' (`project_to_feat_fast`): the largest u32 key `(255 - 8-bit
  depth bucket) << 24 | feature bytes`;
* 'fast_exact' (`project_to_feat_fast_exact`): the exact window, then the
  largest packed feature bytes among its points (one point's bytes);
* 'sorted' (`project_to_feat_sorted`) and 'sorted_packed'
  (`project_to_feat_sorted_packed`): the exact splat's result computed
  over points sorted by (pixel, clipped depth); 'sorted_packed' truncates
  features to bytes, so it equals the exact splat on byte features only;
* 'dual_sorted' (`project_dual_sorted_packed`): 'sorted_packed' over the
  semantic and the RGB cloud in one sort.

The packed modes hold at most 3 feature bytes: with more channels each
returns the exact splat (the sorted one for 'sorted_packed'), as in the
JAX package.

The exact and 'fast' splats run hand-written kernels on CUDA tensors
(`splat_images`, over `splat_cuda`) and their plain PyTorch versions on
CPU tensors (`project_to_feat_plain`, `project_to_feat_fast_plain`). The
other modes are XLA code in the JAX package and plain PyTorch ops here,
on either device.
"""

from __future__ import annotations

import os
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
  return key | pack_bytes(feats, 0)


def pack_bytes(feats: torch.Tensor, shift: int) -> torch.Tensor:
  """(N, M) int64: the feature bytes `clip(feats, 0, 255)` truncated,
  channel 0 highest, shifted left by `shift` bits."""
  fbytes = torch.clamp(torch.nan_to_num(feats, nan=0.0), 0.0, 255.0).to(
      torch.int64)
  channels = feats.shape[-1]
  packed = torch.zeros_like(fbytes[..., 0])
  for c in range(channels):
    packed = packed | (fbytes[..., c] << (8 * (channels - 1 - c) + shift))
  return packed


def unpack_bytes(pbuf: torch.Tensor, channels: int, shift: int,
                 dtype: torch.dtype, output_void_class: float,
                 clamp_to_void: bool = False) -> torch.Tensor:
  """(N, P, C) feature bytes of packed words, `output_void_class` where a
  word is 0 ("no point"); `clamp_to_void` also raises every byte to the
  void value (a scatter-max onto a void-filled buffer)."""
  got_point = pbuf != 0
  void = torch.full((), output_void_class, dtype=dtype, device=pbuf.device)
  cols = []
  for c in range(channels):
    col = ((pbuf >> (8 * (channels - 1 - c) + shift)) & 0xFF).to(dtype)
    if clamp_to_void:
      col = torch.maximum(col, void)
    cols.append(torch.where(got_point, col, void))
  return torch.stack(cols, dim=-1)


def feats_3d(feats: torch.Tensor) -> Tuple[torch.Tensor, bool]:
  """(N, M, C) features and whether they came as scalar (N, M)."""
  if feats.dim() not in (2, 3):
    raise ValueError(
        f'feats should have shape (N, M) or (N, M, C), got {feats.shape}')
  return (feats[..., None], True) if feats.dim() == 2 else (feats, False)


# The packed modes hold at most this many feature bytes in a u32 word
# (with the depth bucket or a valid bit); with more channels they return
# the exact splat, as the JAX package's do.
MAX_PACKED_CHANNELS = 3


def splat_images(exact: bool, points: torch.Tensor, feats: torch.Tensor,
                 height: int, width: int, depth_scale: float,
                 input_void_class: float, output_void_class: float = 0.0,
                 offset: Optional[torch.Tensor] = None,
                 need_depth: bool = True
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
  """A splat's two images from its CUDA kernels (CUDA tensors only).

  The exact (`exact=True`) or 'fast' point pass, then its resolve, with
  the outputs of `project_to_feat` / `project_to_feat_fast`. The 'fast'
  splat of more than 3 channels is the exact one.

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

  feats, is_scalar_feat = feats_3d(feats)
  batch_size, channels = points.shape[0], feats.shape[-1]
  feats = feats.to(points.dtype)
  if exact or channels > MAX_PACKED_CHANNELS:
    depth, feat = splat_cuda.exact_resolve(
        splat_cuda.exact_words(points, feats, height, width, depth_scale,
                               input_void_class, offset=offset),
        depth_scale, output_void_class, need_depth=need_depth)
  else:
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

  feats, is_scalar_feat = feats_3d(feats)
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
  [0, 255] (RGB and semantic classes are). With more than 3 channels the
  bytes do not fit in the key: the result is `project_to_feat`'s.

  CUDA tensors run the 'fast' kernel (`splat_images`); CPU tensors
  `project_to_feat_fast_plain`.

  Args:
    transformed_coords: (N, 4, M) of (x, y, z, 1); z is depth.
    feats: (N, M) or (N, M, C) feature values.
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

  feats, is_scalar_feat = feats_3d(feats)
  channels = feats.shape[-1]
  if channels > MAX_PACKED_CHANNELS:
    return project_to_feat_plain(transformed_coords, feats, height, width,
                                 depth_scale, input_void_class,
                                 output_void_class)
  dtype = transformed_coords.dtype
  feats = feats.to(dtype)
  batch_size = transformed_coords.shape[0]

  zbuf, pbuf = splat_cuda.splat_fast_plain(transformed_coords, feats, height,
                                           width, depth_scale,
                                           input_void_class)
  projected_depth = depth_image(zbuf, depth_scale, height, width)
  projected_feat = unpack_bytes(pbuf, channels, 0, dtype,
                                output_void_class).reshape(
                                    batch_size, height, width, channels)
  if is_scalar_feat:
    projected_feat = projected_feat[..., 0]
  return projected_depth, projected_feat


# -- the modes of plain PyTorch ops on either device --------------------------


def depth_image(zbuf: torch.Tensor, depth_scale: float, height: int,
                width: int) -> torch.Tensor:
  """(N, H, W) depth in [0, 1] from the (N, H*W) minimum-depth buffer."""
  return (torch.clamp(zbuf, 0.0, depth_scale)
          / device_lib.divisor(depth_scale, zbuf)).reshape(
              zbuf.shape[0], height, width)


def min_depth_buffer(flat: torch.Tensor, depth: torch.Tensor,
                     num_pixels: int, depth_scale: float) -> torch.Tensor:
  """(N, num_pixels) f32 scatter-min of the depths at their flat pixel
  index (sentinel `num_pixels`: dropped), from `depth_scale`."""
  zbuf = torch.full((flat.shape[0], num_pixels + 1), depth_scale,
                    dtype=torch.float32, device=flat.device)
  zbuf.scatter_reduce_(1, flat, depth.to(torch.float32), 'amin')
  return zbuf[:, :num_pixels]


def in_window(flat: torch.Tensor, depth: torch.Tensor, valid: torch.Tensor,
              zbuf: torch.Tensor) -> torch.Tensor:
  """Whether each valid point's raw depth is < its pixel's minimum (from
  `zbuf`) + 0.1, the sum in float32."""
  tolerance = torch.full((), DEPTH_COLLISION_TOLERANCE, dtype=torch.float32,
                         device=flat.device)
  min_depth = torch.gather(zbuf, 1, torch.where(valid, flat,
                                                torch.zeros_like(flat)))
  return valid & (depth < min_depth + tolerance)


def scatter_max(buf: torch.Tensor, flat: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
  """`buf` (N, P) with the maximum of `values` (N, M) scattered at `flat`
  (sentinel P: dropped)."""
  out = torch.cat([buf, buf[:, :1]], dim=1)
  out.scatter_reduce_(1, flat, values, 'amax')
  return out[:, :-1]


def project_to_feat_fast_exact(
    transformed_coords: torch.Tensor,
    feats: torch.Tensor,
    height: int,
    width: int,
    depth_scale: float,
    input_void_class: float,
    output_void_class: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Two-pass packed splat with the exact collision window (JAX
  `splat.project_to_feat_fast_exact`).

  Pass 1 takes the exact f32 minimum depth per pixel; pass 2 keeps the
  valid points whose raw depth is < that minimum + 0.1 and takes, per
  pixel, the largest word `1 + (feature bytes << 1)` among them (the +1
  marks "got a point"). So the window is the exact splat's and the
  winner is one point's bytes (the exact splat takes a per-channel max).
  Feature values must be integers in [0, 255]; with more than 3 channels
  the result is `project_to_feat`'s. Plain PyTorch on either device.

  Args and returns as `project_to_feat`.
  """
  feats, is_scalar_feat = feats_3d(feats)
  channels = feats.shape[-1]
  if channels > MAX_PACKED_CHANNELS:
    return project_to_feat(transformed_coords, feats, height, width,
                           depth_scale, input_void_class, output_void_class)
  dtype = transformed_coords.dtype
  feats = feats.to(dtype)
  num_pixels = height * width
  flat, depth, valid = pixel_coords(transformed_coords, feats, height, width,
                                    input_void_class)
  zbuf = min_depth_buffer(flat, depth, num_pixels, depth_scale)
  keep = in_window(flat, depth, valid, zbuf)
  pbuf = scatter_max(
      torch.zeros_like(zbuf, dtype=torch.int64),
      torch.where(keep, flat, torch.full_like(flat, num_pixels)),
      1 + pack_bytes(feats, 1))
  projected_feat = unpack_bytes(pbuf, channels, 1, dtype,
                                output_void_class).reshape(
                                    -1, height, width, channels)
  if is_scalar_feat:
    projected_feat = projected_feat[..., 0]
  return depth_image(zbuf, depth_scale, height, width), projected_feat


def _shift_up(x: torch.Tensor, off: int, fill) -> torch.Tensor:
  """x[:, i - off] along the point axis, `fill` for i < off."""
  pad = torch.full_like(x[:, :off], fill)
  return torch.cat([pad, x[:, :-off]], dim=1)


def _shift_down(x: torch.Tensor, off: int, fill) -> torch.Tensor:
  """x[:, i + off] along the point axis, `fill` for i >= M - off."""
  pad = torch.full_like(x[:, -off:], fill)
  return torch.cat([x[:, off:], pad], dim=1)


def _segmented_window_max(sflat: torch.Tensor, sclip: torch.Tensor,
                          sraw: torch.Tensor, svals: torch.Tensor,
                          num_pixels: int, neg) -> torch.Tensor:
  """Per-run window max over (pixel, depth)-sorted points (JAX
  `splat._segmented_window_max`, with a leading batch axis).

  Log-step passes: a segmented prefix-min of the clipped depth gives
  each point its run's minimum; a point is in the window when it is
  valid (pixel < `num_pixels`) and its raw depth is < that minimum + 0.1
  (float32); then a segmented suffix-max per channel of the window's
  values (`neg` elsewhere) leaves at each run's start the run's window
  maximum, which dominates every other point of the run.

  Args:
    sflat: (N, M) int64 pixel ids, ascending per batch element.
    sclip: (N, M) depth clipped to depth_scale, ascending within a run.
    sraw: (N, M) raw depth.
    svals: (N, M, C) values.
    neg: the value every real one beats (-inf, or -1 for byte lanes).

  Returns:
    (N, M, C) suffix window maxima.
  """
  num_points = sflat.shape[1]
  run_min = sclip
  off = 1
  while off < num_points:
    same = _shift_up(sflat, off, -1) == sflat
    run_min = torch.where(same, torch.minimum(
        run_min, _shift_up(run_min, off, float('inf'))), run_min)
    off *= 2
  tolerance = torch.full((), DEPTH_COLLISION_TOLERANCE, dtype=sraw.dtype,
                         device=sraw.device)
  window = (sflat < num_pixels) & (sraw < run_min + tolerance)
  chans = [torch.where(window, svals[..., c],
                       torch.full_like(svals[..., c], neg))
           for c in range(svals.shape[-1])]
  off = 1
  while off < num_points:
    same = _shift_down(sflat, off, -1) == sflat
    chans = [torch.where(same, torch.maximum(v, _shift_down(v, off, neg)), v)
             for v in chans]
    off *= 2
  return torch.stack(chans, dim=-1)


def _sort_by_pixel_depth(flat: torch.Tensor, depth: torch.Tensor,
                         depth_scale: float, sentinel: int,
                         *payloads: torch.Tensor):
  """Sorts each batch element's points by (pixel id, clipped depth).

  One int64 key per point: the pixel id above the clipped depth's float
  bits (a positive float's bits order as the float does). Points with
  the sentinel id are invalid: their depth (possibly negative or NaN) is
  left out of the key, so they sort last in any order. The window max
  does not depend on the order of equal keys, so no stable sort is
  needed (the JAX package's `lax.sort` is not stable either).

  Returns (sorted ids, sorted clipped depth, sorted raw depth, each
  payload (N, M[, C]) sorted).
  """
  clipped = torch.clamp(depth, max=depth_scale)
  bits = torch.where(flat < sentinel, clipped.view(torch.int32).to(
      torch.int64), torch.zeros_like(flat))
  order = torch.argsort((flat << 32) | bits, dim=1)
  take = lambda t: torch.gather(
      t, 1, order if t.dim() == 2 else order[..., None].expand(t.shape))
  return (take(flat), take(clipped), take(depth),
          *(take(p) for p in payloads))


def project_to_feat_sorted(
    transformed_coords: torch.Tensor,
    feats: torch.Tensor,
    height: int,
    width: int,
    depth_scale: float,
    input_void_class: float,
    output_void_class: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Sort-based exact splat (JAX `splat.project_to_feat_sorted`), equal
  to `project_to_feat` on any float features.

  Sorts the points by (pixel, clipped depth), takes the window maxima of
  `_segmented_window_max` and scatter-maxes them onto a void-filled
  image. Plain PyTorch on either device. Args and returns as
  `project_to_feat`.
  """
  feats, is_scalar_feat = feats_3d(feats)
  dtype = transformed_coords.dtype
  feats = feats.to(dtype)
  channels = feats.shape[-1]
  num_pixels = height * width
  flat, depth, _ = pixel_coords(transformed_coords, feats, height, width,
                                input_void_class)
  zbuf = min_depth_buffer(flat, depth, num_pixels, depth_scale)
  sflat, sclip, sraw, svals = _sort_by_pixel_depth(
      flat, depth, depth_scale, num_pixels, feats)
  seg = _segmented_window_max(sflat, sclip, sraw, svals, num_pixels,
                              float('-inf'))
  void = torch.full_like(zbuf, output_void_class, dtype=dtype)
  projected_feat = torch.stack(
      [scatter_max(void, sflat, seg[..., c]) for c in range(channels)],
      dim=-1).reshape(-1, height, width, channels)
  if is_scalar_feat:
    projected_feat = projected_feat[..., 0]
  return depth_image(zbuf, depth_scale, height, width), projected_feat


def _window_packed(sflat, sclip, sraw, spacked, channels, num_pixels):
  """The packed sorted modes' window: byte lanes of the sorted packed
  words, their window maxima, repacked above a valid bit (0 for a run
  whose window is empty)."""
  lanes = torch.stack([(spacked >> (8 * (channels - 1 - c))) & 0xFF
                       for c in range(channels)], dim=-1)
  seg = _segmented_window_max(sflat, sclip, sraw, lanes, num_pixels, -1)
  out = torch.zeros_like(spacked)
  for c in range(channels):
    out = out | ((seg[..., c] & 0xFF) << (8 * (channels - 1 - c) + 1))
  return torch.where(seg[..., 0] >= 0, out | 1, torch.zeros_like(out))


def _check_bytes(feats: torch.Tensor, valid: torch.Tensor) -> None:
  """With SE3DS_DEBUG_SPLAT=1, raises unless the valid points' features
  are integers in [0, 255] (the JAX package's debug trap)."""
  if os.environ.get('SE3DS_DEBUG_SPLAT', '0') != '1':
    return
  if feats.is_cuda and torch.cuda.is_current_stream_capturing():
    raise RuntimeError(
        'SE3DS_DEBUG_SPLAT=1 reads the features back to the host, which a '
        'captured CUDA graph cannot do; serve with cuda_graphs=False.')
  bad = valid[..., None] & ((feats != torch.round(feats)) | (feats < 0)
                            | (feats > 255))
  if bool(bad.any()):
    raise ValueError(
        "splat_mode='sorted_packed' requires integer features in [0, 255] "
        "on valid points; got non-byte values. Use splat_mode='sorted' for "
        'general float features.')


def project_to_feat_sorted_packed(
    transformed_coords: torch.Tensor,
    feats: torch.Tensor,
    height: int,
    width: int,
    depth_scale: float,
    input_void_class: float,
    output_void_class: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Byte-packed sorted splat (JAX `splat.project_to_feat_sorted_packed`).

  The features ride the (pixel, clipped depth) sort as one packed word of
  bytes `clip(feats, 0, 255)` truncated; the window maxima run on the
  byte lanes and one scatter-max of the repacked words resolves the
  image, each byte raised to the void value. Equal to `project_to_feat`
  when the features are integers in [0, 255]; other features clip and
  truncate (validity still tests the original values). With more than 3
  channels it is `project_to_feat_sorted`. SE3DS_DEBUG_SPLAT=1 raises
  ValueError on non-byte features of valid points. Plain PyTorch on
  either device. Args and returns as `project_to_feat`.
  """
  feats, is_scalar_feat = feats_3d(feats)
  channels = feats.shape[-1]
  if channels > MAX_PACKED_CHANNELS:
    return project_to_feat_sorted(transformed_coords, feats, height, width,
                                  depth_scale, input_void_class,
                                  output_void_class)
  dtype = transformed_coords.dtype
  feats = feats.to(dtype)
  num_pixels = height * width
  flat, depth, valid = pixel_coords(transformed_coords, feats, height, width,
                                    input_void_class)
  _check_bytes(feats, valid)
  zbuf = min_depth_buffer(flat, depth, num_pixels, depth_scale)
  sflat, sclip, sraw, spacked = _sort_by_pixel_depth(
      flat, depth, depth_scale, num_pixels, pack_bytes(feats, 0))
  pbuf = scatter_max(torch.zeros_like(zbuf, dtype=torch.int64), sflat,
                     _window_packed(sflat, sclip, sraw, spacked, channels,
                                    num_pixels))
  projected_feat = unpack_bytes(pbuf, channels, 1, dtype, output_void_class,
                                clamp_to_void=True).reshape(
                                    -1, height, width, channels)
  if is_scalar_feat:
    projected_feat = projected_feat[..., 0]
  return depth_image(zbuf, depth_scale, height, width), projected_feat


def project_dual_sorted_packed(
    sem_coords: torch.Tensor,
    sem_feats: torch.Tensor,
    rgb_coords: torch.Tensor,
    rgb_feats: torch.Tensor,
    height: int,
    width: int,
    depth_scale: float,
    sem_void_class: float,
    rgb_void_class: float,
    output_void_class: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The semantic and the RGB splat in one sort (JAX
  `splat.project_dual_sorted_packed`).

  Both clouds share one id space: semantic pixels [0, P), RGB pixels
  [P, 2P) (P = height * width), sentinel 2P. One (id, clipped depth)
  sort of the union, the window maxima of `project_to_feat_sorted_packed`
  (a run never mixes the clouds), one scatter-max into 2P words. Equal to
  `project_to_feat` on each cloud for byte features. The depth image is
  the RGB cloud's. Plain PyTorch on either device.

  Args:
    sem_coords: (N, 4, Ms) view coordinates of the semantic cloud.
    sem_feats: (N, Ms, 1) class ids.
    rgb_coords: (N, 4, Mr) view coordinates of the RGB cloud.
    rgb_feats: (N, Mr, 3) RGB bytes.

  Returns:
    (rgb depth (N, H, W), semantic image (N, H, W, 1), RGB image
    (N, H, W, 3)).
  """
  dtype = rgb_coords.dtype
  sem_feats = sem_feats.to(dtype)
  rgb_feats = rgb_feats.to(dtype)
  num_pixels = height * width
  flat_s, depth_s, _ = pixel_coords(sem_coords, sem_feats, height, width,
                                    sem_void_class)
  flat_r, depth_r, _ = pixel_coords(rgb_coords, rgb_feats, height, width,
                                    rgb_void_class)
  zbuf = min_depth_buffer(flat_r, depth_r, num_pixels, depth_scale)
  sentinel = torch.full_like(flat_s[:, :1], 2 * num_pixels)
  ids = torch.cat([
      torch.where(flat_s < num_pixels, flat_s, sentinel),
      torch.where(flat_r < num_pixels, flat_r + num_pixels, sentinel)], dim=1)
  packed = torch.cat([pack_bytes(sem_feats[..., :1], 16),
                      pack_bytes(rgb_feats, 0)], dim=1)
  sids, sclip, sraw, spacked = _sort_by_pixel_depth(
      ids, torch.cat([depth_s, depth_r], dim=1), depth_scale,
      2 * num_pixels, packed)
  pbuf = scatter_max(
      torch.zeros((ids.shape[0], 2 * num_pixels), dtype=torch.int64,
                  device=ids.device), sids,
      _window_packed(sids, sclip, sraw, spacked, 3, 2 * num_pixels))
  unpack = lambda part, channels: unpack_bytes(
      part, 3, 1, dtype, output_void_class, clamp_to_void=True)[
          ..., :channels].reshape(-1, height, width, channels)
  return (depth_image(zbuf, depth_scale, height, width),
          unpack(pbuf[:, :num_pixels], 1), unpack(pbuf[:, num_pixels:], 3))


def reference_pollute_pixel0(
    projected_depth: torch.Tensor,
    projected_feat: torch.Tensor,
    transformed_coords: torch.Tensor,
    feats: torch.Tensor,
    height: int,
    width: int,
    input_void_class: float,
    depth_scale: float,
    output_void_class: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """The reference's flat-index-0 pollution, for parity tests only (JAX
  `splat.reference_pollute_pixel0`; no serving path calls it).

  The reference scatter sends invalid points, and then the depth-window
  losers, to flat index 0 (pixel (0, 0) of batch element 0): its depth
  becomes the minimum over those points' depths (clipped), its features
  the maximum over every invalid point and window loser of every batch
  element, with its own winners and the void value. The splat modes drop
  those points instead; this rewrites pixel (0, 0) of batch element 0 of
  a clean splat output (copies; the inputs are not modified).

  Args:
    projected_depth: (N, H, W) clean splat depth in [0, 1].
    projected_feat: (N, H, W, C) or (N, H, W) clean splat features.
    transformed_coords: (N, 4, M) view coordinates the splat consumed.
    feats: (N, M) or (N, M, C) point features.

  Returns:
    (projected_depth, projected_feat) with pixel (0, 0) of batch 0
    replaced.
  """
  is_scalar_feat = feats.dim() == 2
  if is_scalar_feat:
    feats = feats[..., None]
  dtype = transformed_coords.dtype
  f = feats.to(dtype)
  batch_size = transformed_coords.shape[0]
  num_pixels = height * width
  flat, depth, valid = pixel_coords(transformed_coords, f, height, width,
                                    input_void_class)
  offsets = (torch.arange(batch_size, device=flat.device)
             * num_pixels)[:, None]
  flat_g = torch.where(valid, flat + offsets, torch.zeros_like(flat)).reshape(
      -1)
  d = depth.reshape(-1)
  scat = torch.full((batch_size * num_pixels,), depth_scale, dtype=dtype,
                    device=flat.device)
  scat.scatter_reduce_(0, flat_g, d, 'amin')
  depth0 = (torch.clamp(scat[0], 0.0, depth_scale)
            / device_lib.divisor(depth_scale, scat))
  tolerance = torch.full((), DEPTH_COLLISION_TOLERANCE, dtype=dtype,
                         device=flat.device)
  flat2 = flat_g * (d < scat[flat_g] + tolerance).to(flat_g.dtype)
  cand = torch.where((flat2 == 0)[:, None], f.reshape(-1, f.shape[-1]),
                     torch.full((), float('-inf'), dtype=dtype,
                                device=flat.device))
  feat0 = torch.maximum(
      torch.full((), output_void_class, dtype=dtype, device=flat.device),
      torch.amax(cand, dim=0))
  projected_depth = projected_depth.clone()
  projected_feat = projected_feat.clone()
  projected_depth[0, 0, 0] = depth0.to(projected_depth.dtype)
  projected_feat[0, 0, 0] = (feat0[0] if is_scalar_feat else feat0).to(
      projected_feat.dtype)
  return projected_depth, projected_feat
