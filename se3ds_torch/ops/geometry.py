"""Equirectangular panorama geometry (port of `se3ds_tpu.ops.geometry`).

Point-cloud unprojection, the equirectangular view coordinates, the
splat dispatch (with `project_memory_equirect`, the memory splat at a
camera offset that the kernels fuse with the view coordinates), the pole
mask and crop, pano rotation, and the perspective <-> equirectangular
warps of the RE10K flow.
Conventions follow the JAX package: world z up toward the pano's north
pole, heading measured from the x-axis toward the y-axis; pixel rays are
x-right / y-down / z-forward. The JAX package runs its 3x3 products at
`Precision.HIGHEST`; here they are written as float32 multiply-adds, so
no TF32 reaches them on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from se3ds_torch import constants
from se3ds_torch import device as device_lib
from se3ds_torch.ops import image as image_ops
from se3ds_torch.ops import splat

# Each splat mode of the JAX package: the CUDA kernel it runs on the card
# ('exact', 'fast', or None for a mode of plain PyTorch ops on either
# device) and its function on view coordinates on the CPU. The exact
# modes are bit-identical in the JAX package ('scatter' is their
# definition; `splat.project_to_feat_sorted` is 'sorted' as written
# there), so all three run the exact splat; 'pallas' is 'fast'.
# 'dual_sorted' splats the two clouds of a memory together
# (`project_dual_to_equirectangular`, `inference.memory_project`).
_SPLATS = {
    'scatter': ('exact', splat.project_to_feat_plain),
    'sorted': ('exact', splat.project_to_feat_plain),
    'pallas_exact': ('exact', splat.project_to_feat_plain),
    'fast': ('fast', splat.project_to_feat_fast_plain),
    'pallas': ('fast', splat.project_to_feat_fast_plain),
    'fast_exact': (None, splat.project_to_feat_fast_exact),
    'sorted_packed': (None, splat.project_to_feat_sorted_packed),
}
SPLAT_MODES = tuple(_SPLATS) + ('dual_sorted',)


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


def _splat(splat_mode: Optional[str]):
  """`_SPLATS[splat_mode]` (None is 'scatter'); raises ValueError on a
  mode of no single-cloud splat."""
  splat_mode = 'scatter' if splat_mode is None else splat_mode
  if splat_mode not in _SPLATS:
    hint = (' (it splats both clouds: project_dual_to_equirectangular)'
            if splat_mode in SPLAT_MODES else '')
    raise ValueError(f'splat_mode={splat_mode!r} is not a single-cloud '
                     f'splat mode{hint}; use one of {tuple(_SPLATS)}.')
  return _SPLATS[splat_mode]


def project_feats_to_equirectangular(
    feats: torch.Tensor,
    xyz1: torch.Tensor,
    height: int,
    width: int,
    void_class: float,
    depth_scale: float,
    use_sorted_splat: bool = False,
    splat_mode: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Projects point-cloud features into an equirectangular image.

  This is `project_memory_equirect` at a zero offset: on CUDA tensors the
  kernels compute the view coordinates; on CPU tensors the plain path,
  `equirect_view_coords` then the splat's plain version (x - 0 == x).
  The arguments are the JAX function's, in its order.

  Args:
    feats: (N, M) or (N, M, C) point features.
    xyz1: (N, 4, M) homogeneous point coordinates.
    height, width: Output pano size in pixels.
    void_class: Feature value marking an empty point.
    depth_scale: Maximum depth in metres.
    use_sorted_splat: the JAX package's legacy alias of
      splat_mode='sorted', read when `splat_mode` is None.
    splat_mode: None ('scatter', the JAX default); the exact modes
      'scatter', 'sorted' and 'pallas_exact' (on the card the exact CUDA
      kernel); 'fast' or 'pallas' (on the card the 'fast' CUDA kernel, or
      the exact one for more than 3 channels); 'fast_exact' or
      'sorted_packed' (PyTorch ops on either device; `splat`).

  Returns:
    reprojected_depth: (N, H, W) depth in [0, 1].
    reprojected_feats: (N, H, W[, C]) feature image.
  """
  if splat_mode is None:
    splat_mode = 'sorted' if use_sorted_splat else 'scatter'
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
  no translated copy or view tensor is written. CPU tensors, and the
  modes without a kernel on either device, take
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
  kernel, _ = _splat(splat_mode)
  if xyz1.is_cuda and kernel is not None:
    return splat.splat_images(kernel == 'exact', xyz1, feats, height, width,
                              depth_scale, void_class, offset=offset,
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
  splat's plain version (what the CPU runs), or the mode's function for
  a mode without a kernel."""
  _, splat_fn = _splat(splat_mode)
  return splat_fn(equirect_view_coords(xyz1 - offset[..., None]),
                  feats.to(xyz1.dtype), height, width,
                  depth_scale=depth_scale, input_void_class=void_class)


def project_dual_to_equirectangular(
    sem_feats: torch.Tensor,
    sem_xyz1: torch.Tensor,
    rgb_feats: torch.Tensor,
    rgb_xyz1: torch.Tensor,
    height: int,
    width: int,
    sem_void_class: float,
    rgb_void_class: float,
    depth_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The semantic and the RGB equirect splat in one sort (JAX
  `geometry.project_dual_to_equirectangular`): both clouds' view
  coordinates through `splat.project_dual_sorted_packed`. Plain PyTorch
  on either device.

  Returns (rgb depth (N, H, W), semantic image (N, H, W, 1), RGB image
  (N, H, W, 3)).
  """
  dtype = rgb_xyz1.dtype
  return splat.project_dual_sorted_packed(
      equirect_view_coords(sem_xyz1), sem_feats.to(dtype),
      equirect_view_coords(rgb_xyz1), rgb_feats.to(dtype), height, width,
      depth_scale=depth_scale, sem_void_class=sem_void_class,
      rgb_void_class=rgb_void_class)


def _linspace_f32(start: float, stop: float, num: int,
                  device: torch.device) -> torch.Tensor:
  """float32 linspace with the same bits as `jnp.linspace` (f32 default).

  jnp.linspace computes `start * (1 - t) + stop * t` with `t = i / (num -
  1)` in float32 and sets the last element to `stop` exactly.
  Computed on `device` by float32 ops that each round once (numpy's
  bits): no host copy, so a captured CUDA graph can hold it.
  """
  start32, stop32 = float(np.float32(start)), float(np.float32(stop))
  if num == 1:
    return torch.full((1,), start32, dtype=torch.float32, device=device)
  t = torch.arange(num, dtype=torch.float32, device=device)
  t = t / device_lib.divisor(num - 1, t)
  out = start32 * (1 - t) + stop32 * t
  out[-1:].fill_(stop32)
  return out


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
    size_mult: Resamples the pano to (H, W) * size_mult first (depth by
      nearest, features by `interpolation_method`).
    interpolation_method: 'nearest', 'bilinear' or 'bicubic'. Without a
      resample, bilinear only casts the features to float32, as the JAX
      package does.

  Returns:
    xyz1: (N, 4, H'*W') homogeneous coordinates.
    filtered_feats: (N, H'*W'[, C]) features.
  """
  if feats.dim() not in (3, 4):
    raise ValueError('feats should have shape (N, H, W) or (N, H, W, C),'
                     f' got {tuple(feats.shape)} instead.')
  if interpolation_method not in ('nearest', 'bilinear', 'bicubic'):
    raise ValueError(f'unknown interpolation_method {interpolation_method!r}')
  is_scalar_feat = feats.dim() == 3
  if is_scalar_feat:
    feats = feats[..., None]
  batch_size, height, width, channels = feats.shape
  if width != 2 * height:
    raise ValueError('Expected equirectangular input images')
  height, width = int(height * size_mult), int(width * size_mult)
  dtype = depth.dtype
  if (height, width) != tuple(feats.shape[1:3]):
    depth = image_ops.resize(depth[..., None], (height, width),
                             method='nearest')[..., 0]
    feats = image_ops.resize(feats, (height, width),
                             method=interpolation_method)
  elif interpolation_method != 'nearest':
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
              method: str = 'bilinear',
              resize_to_original: bool = False) -> torch.Tensor:
  """Crops away the top/bottom `proportion` rows of (N, H, W, C) or
  (H, W, C) panos (JAX `geometry.crop_pano`); `resize_to_original`
  resizes the crop back to (H, W) with `method`, antialiased, and casts
  it to the pano's dtype."""
  if pano.dim() not in (3, 4):
    raise ValueError(f'pano should be of shape (N, H, W, C), got '
                     f'{tuple(pano.shape)} instead.')
  row_axis = pano.dim() - 3
  height, width = pano.shape[row_axis], pano.shape[row_axis + 1]
  masked_height = int(height * proportion)
  cropped = pano.narrow(row_axis, masked_height, height - 2 * masked_height)
  if not resize_to_original:
    return cropped
  return image_ops.resize(cropped, (height, width), method=method,
                          antialias=True).to(pano.dtype)


def _divide(x: torch.Tensor, value: float) -> torch.Tensor:
  """`x / value` as a true float32 division on either device."""
  return x / device_lib.divisor(value, x)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """(..., I, K) @ (..., K, J) in float32 multiply-adds, summed in order
  (no TF32 on the card)."""
  out = a[..., :, 0:1] * b[..., 0:1, :]
  for k in range(1, a.shape[-1]):
    out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
  return out


def get_world_to_image_transform(
    image_shape,
    fov,
    camera_intrinsics: Optional[torch.Tensor] = None,
    rotations: Optional[Tuple[float, float]] = None,
    rotation_matrix: Optional[torch.Tensor] = None,
    device=None) -> torch.Tensor:
  """The 3x3 float32 world-to-image transform: intrinsics (from `fov` =
  (fov_y, fov_x) in radians when `camera_intrinsics` is None) times the
  extrinsic rotation (pitch then heading from `rotations`, else
  `rotation_matrix`, else the identity)."""
  f32 = dict(dtype=torch.float32, device=device)
  if camera_intrinsics is None:
    height, width = image_shape
    fov = torch.as_tensor(fov, **f32)
    fov_y, fov_x = fov[0], fov[1]
    fx = torch.tensor(0.5 * (width - 1.0), **f32) / torch.tan(
        _divide(fov_x, 2))
    fy = torch.tensor(0.5 * (height - 1.0), **f32) / torch.tan(
        _divide(fov_y, 2))
    zero = torch.zeros((), **f32)
    camera_intrinsics = torch.stack([
        torch.stack([fx, zero, torch.tensor(0.5 * (width - 1), **f32)]),
        torch.stack([zero, fy, torch.tensor(0.5 * (height - 1), **f32)]),
        torch.tensor([0.0, 0.0, 1.0], **f32)])
  camera_intrinsics = torch.as_tensor(camera_intrinsics, **f32)
  if rotations is not None:
    pitch = -torch.as_tensor(rotations[0], **f32)
    heading = -torch.as_tensor(rotations[1], **f32)
    one, zero = torch.ones_like(pitch), torch.zeros_like(pitch)
    pitch_rotation = torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([zero, torch.cos(pitch), -torch.sin(pitch)]),
        torch.stack([zero, torch.sin(pitch), torch.cos(pitch)])])
    heading_rotation = torch.stack([
        torch.stack([torch.cos(heading), zero, torch.sin(heading)]),
        torch.stack([zero, one, zero]),
        torch.stack([-torch.sin(heading), zero, torch.cos(heading)])])
    extrinsics = _matmul3(pitch_rotation, heading_rotation)
  elif rotation_matrix is not None:
    extrinsics = torch.as_tensor(rotation_matrix, **f32)
  else:
    extrinsics = torch.eye(3, **f32)
  return _matmul3(camera_intrinsics, extrinsics)


def equirectangular_pixel_rays(output_height: int,
                               device=None) -> torch.Tensor:
  """(3, H * 2H) float32 unit ray per pixel, x-right/y-down/z-forward."""
  output_width = int(output_height) * 2
  heading = _linspace_f32(-math.pi, math.pi, output_width, device)[None, :]
  pitch = _linspace_f32(0.0, math.pi, output_height, device)[:, None]
  xs = torch.sin(pitch) * torch.sin(heading)
  ys = (-torch.cos(pitch)).expand(-1, output_width)
  zs = torch.sin(pitch) * torch.cos(heading)
  return torch.stack([xs, ys, zs], dim=0).reshape(3, -1)


def rotate_pano(pano: torch.Tensor, matrix: torch.Tensor,
                output_height: Optional[int] = None) -> torch.Tensor:
  """Rotates (N, H, 2H, C) equirectangular panos by (N, 3, 3) matrices;
  returns float32 (N, H', 2H', C)."""
  n, height, width, channels = pano.shape
  if width != height * 2:
    raise ValueError('Pano width must be twice height.')
  out_height = output_height if output_height is not None else height
  pixel_rays = equirectangular_pixel_rays(out_height, pano.device)
  matrix = torch.as_tensor(matrix, dtype=torch.float32, device=pano.device)
  rotated = _matmul3(matrix, pixel_rays[None])
  x, y, z = rotated[:, 0], rotated[:, 1], rotated[:, 2]
  pitch = torch.arccos(torch.clamp(-y, -1.0, 1.0))
  heading = torch.atan2(x, z)
  heading_pixels = (_divide(heading, 2 * math.pi) + 0.5) * (width - 1)
  pitch_pixels = _divide(pitch, math.pi) * (height - 1)
  coords = torch.stack([pitch_pixels, heading_pixels], dim=-1)
  out = image_ops.interpolate_bilinear(pano, coords, indexing='ij')
  return out.reshape(n, out_height, 2 * out_height, channels)


def project_perspective_image(image: torch.Tensor,
                              fov,
                              output_height: int,
                              camera_intrinsics=None,
                              rotations=None,
                              rotation_matrix=None,
                              pad_mode: str = 'constant',
                              pad_value: float = 0.0,
                              round_to_nearest: bool = False
                              ) -> torch.Tensor:
  """Warps an (H, W, C) perspective image onto an (H', 2H', C) float32
  equirectangular pano.

  Pixels whose ray points behind the camera (or outside the image) read
  the padding: `pad_value` ('constant'), the image mean ('mean'), or the
  clamped border ('reflect', no padding). `round_to_nearest` samples the
  nearest source pixel.
  """
  if pad_mode not in ('reflect', 'constant', 'mean'):
    raise ValueError(f'unknown pad_mode {pad_mode!r}')
  image = image[None]
  world_coordinates = equirectangular_pixel_rays(output_height, image.device)
  world_to_image = get_world_to_image_transform(
      (image.shape[1], image.shape[2]), fov,
      camera_intrinsics=camera_intrinsics, rotations=rotations,
      rotation_matrix=rotation_matrix, device=image.device)
  image_coordinates = _matmul3(world_to_image, world_coordinates).T
  xs_and_ys = image_coordinates[:, :2]
  zs = image_coordinates[:, 2:]
  image_coordinates = torch.where(
      zs > 0, xs_and_ys / torch.where(zs == 0, torch.ones_like(zs), zs),
      -torch.ones_like(xs_and_ys))
  if round_to_nearest:
    image_coordinates = torch.round(image_coordinates)
  if pad_mode != 'reflect':
    value = (torch.mean(image.to(torch.float32)) if pad_mode == 'mean'
             else torch.tensor(pad_value, dtype=image.dtype,
                               device=image.device))
    padded = value.to(image.dtype).expand(
        1, image.shape[1] + 2, image.shape[2] + 2, image.shape[3]).clone()
    padded[:, 1:-1, 1:-1] = image
    image = padded
    image_coordinates = image_coordinates + 1.0
  out = image_ops.interpolate_bilinear(image, image_coordinates[None],
                                       indexing='xy')
  return out.reshape(output_height, 2 * output_height, -1)


def _xyz_to_lonlat(xyz: torch.Tensor) -> torch.Tensor:
  """World coordinates -> (longitude, latitude)."""
  norm = torch.sqrt(torch.sum(xyz * xyz, dim=-1, keepdim=True))
  xyz_norm = xyz / norm
  x, y, z = xyz_norm[..., 0:1], xyz_norm[..., 1:2], xyz_norm[..., 2:]
  lon = torch.atan2(x, z)
  lat = torch.arcsin(torch.clamp(y, -1.0, 1.0))
  return torch.cat([lon, lat], dim=-1)


def _lonlat_to_uv(lonlat: torch.Tensor, shape) -> torch.Tensor:
  """(lon, lat) -> pano (u, v) pixel coordinates."""
  u = (_divide(lonlat[..., 0:1], 2 * math.pi) + 0.5) * (shape[1] - 1)
  v = (_divide(lonlat[..., 1:], math.pi) + 0.5) * (shape[0] - 1)
  return torch.cat([u, v], dim=-1)


def get_perspective_from_equirectangular_image(
    image: torch.Tensor, camera_intrinsics, rotation_matrix, height: int,
    width: int) -> torch.Tensor:
  """Samples an (height, width, C) float32 perspective view out of an
  (H, 2H, C) pano, for 3x3 intrinsics and a 3x3 rotation."""
  eq_height, eq_width, channels = image.shape
  f32 = dict(dtype=torch.float32, device=image.device)
  y, x = torch.meshgrid(torch.arange(height, **f32),
                        torch.arange(width, **f32), indexing='ij')
  xyz = torch.stack([x, y, torch.ones_like(x)], dim=-1)
  inverse = torch.linalg.inv(torch.as_tensor(camera_intrinsics, **f32))
  xyz = _matmul3(_matmul3(xyz, inverse.T),
                 torch.as_tensor(rotation_matrix, **f32))
  uv = _lonlat_to_uv(_xyz_to_lonlat(xyz), (eq_height, eq_width))
  out = image_ops.interpolate_bilinear(image[None].to(torch.float32),
                                       uv.reshape(1, -1, 2), indexing='xy')
  return out.reshape(height, width, channels)


def get_intrinsic_matrix(hfov: float = constants.HFOV,
                         device=None) -> torch.Tensor:
  """(4, 4) float32 pinhole intrinsics for a horizontal field of view."""
  f = 1.0 / math.tan(hfov / 2.0)
  return torch.tensor([[f, 0.0, 0.0, 0.0], [0.0, f, 0.0, 0.0],
                       [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                      dtype=torch.float32, device=device)


def get_filtered_coords_and_feats(
    feats: torch.Tensor,
    depth: torch.Tensor,
    depth_scale: float,
    hfov: float = constants.HFOV,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Pinhole unprojection of a perspective image into a camera-space
  point cloud; coordinates and features of invalid depths (<= 0 or >=
  depth_scale in metres) are zeroed (zero is the void class).

  Args:
    feats: (N, H, W) or (N, H, W, C) feature values.
    depth: (N, H, W) depth in [0, 1].
    depth_scale: Maximum depth in metres.
    hfov: Horizontal field of view in radians.

  Returns:
    xyz: (N, 4, H*W) float32 homogeneous camera-frame coordinates.
    filtered_feats: (N, H*W[, C]) float32 features.
  """
  if feats.dim() not in (3, 4):
    raise ValueError('feats should have shape (N, H, W) or (N, H, W, C),'
                     f' got {tuple(feats.shape)} instead.')
  is_scalar_feat = feats.dim() == 3
  if is_scalar_feat:
    feats = feats[..., None]
  batch_size, height, width = depth.shape
  channels = feats.shape[-1]
  device = depth.device
  ys = _linspace_f32(-1.0, 1.0, height, device)[:, None].expand(-1, width)
  xs = _linspace_f32(-1.0, 1.0, width, device)[None, :].expand(height, -1)
  metric_depth = (depth * depth_scale)[:, None, :, :]
  xyz = torch.cat([xs * metric_depth, ys * metric_depth, metric_depth,
                   torch.ones_like(metric_depth)], dim=1)
  flat_depth = metric_depth.reshape(batch_size, -1)
  depth_mask = (flat_depth > 0) & (flat_depth < depth_scale)
  filtered_feats = feats.reshape(batch_size, -1, channels)
  filtered_feats = (filtered_feats * depth_mask[..., None].to(
      filtered_feats.dtype)).to(torch.float32)
  xyz = xyz.reshape(batch_size, 4, -1) * depth_mask[:, None, :].to(
      torch.float32)
  inverse = torch.linalg.inv(get_intrinsic_matrix(hfov, device))
  xyz = _matmul3(inverse, xyz)
  if is_scalar_feat:
    filtered_feats = filtered_feats[..., 0]
  return xyz, filtered_feats
