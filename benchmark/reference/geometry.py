"""Plain PyTorch reference of the serving path's geometry.

A frozen copy of the arithmetic the served frame runs before and after
the generator: the pole mask, the unprojection of an RGB-D panorama into
world points (with the pole rows dropped from the RGB cloud), the
equirectangular view coordinates, the 'fast' z-buffer splat (per pixel
the exact minimum depth and the largest key `(255 - 8-bit depth bucket)
<< 24 | feature bytes`), the guidance mask and the generator's inputs.
It imports nothing of the program: the benchmark holds the program's
outputs to it.

Every division by a constant is a true float32 division (a 0-dim
divisor on the device): PyTorch's CUDA division by a Python scalar
multiplies by the reciprocal, which can move a point by an ULP.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

INVALID_SEM_VALUE = 0
INVALID_RGB_VALUE = -1
POLE_PROPORTION = 0.125


def divisor(value: float, like: torch.Tensor) -> torch.Tensor:
  dtype = like.dtype if like.is_floating_point() else torch.float32
  return torch.full((), value, dtype=dtype, device=like.device)


def pole_valid_rows(height: int) -> Tuple[int, int]:
  """Rows [start, stop) the pole mask leaves."""
  masked = int(height * POLE_PROPORTION)
  return masked, height - masked + 1


def mask_pano(pano: torch.Tensor, value: float) -> torch.Tensor:
  """Sets the top and bottom eighth of (N, H, W, C) panos to `value`."""
  height = pano.shape[1]
  masked = int(height * POLE_PROPORTION)
  rows = torch.arange(height, device=pano.device)
  keep = ((rows >= masked) & (rows <= height - masked)).to(pano.dtype)
  keep = keep[None, :, None, None]
  return keep * pano + (1 - keep) * value


def linspace_f32(start: float, stop: float, num: int,
                 device: torch.device) -> torch.Tensor:
  """numpy's float32 linspace bits: start * (1 - t) + stop * t."""
  start32 = float(torch.tensor(start, dtype=torch.float32))
  stop32 = float(torch.tensor(stop, dtype=torch.float32))
  t = torch.arange(num, dtype=torch.float32, device=device)
  t = t / divisor(num - 1, t)
  out = start32 * (1 - t) + stop32 * t
  out[-1:].fill_(stop32)
  return out


def unproject(feats: torch.Tensor, depth: torch.Tensor, void: float,
              depth_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
  """(N, H, W, C) features and (N, H, W) depth in [0, 1] -> world points
  (N, 4, H*W) at the pano's centre and features (N, H*W, C); points of
  invalid depth get the void feature and coordinates (0, 0, 0, 1)."""
  batch, height, width, channels = feats.shape
  half_pixel = 0.5 * math.pi / height
  elevation = linspace_f32(half_pixel, math.pi - half_pixel, height,
                           depth.device)
  heading = linspace_f32(1.5 * math.pi - half_pixel,
                         -0.5 * math.pi + half_pixel, width, depth.device)
  valid = ((depth > 0) & (depth < 1.0)).to(depth.dtype)
  rad = (depth * depth_scale) * valid
  feats = torch.where(valid[..., None] == 0,
                      torch.full((), void, dtype=feats.dtype,
                                 device=feats.device), feats)
  sin_elev = torch.sin(elevation)[:, None]
  x = rad * sin_elev * torch.cos(heading)[None, :]
  y = rad * sin_elev * torch.sin(heading)[None, :]
  z = rad * torch.cos(elevation)[:, None]
  xyz1 = torch.stack([x.reshape(batch, -1), y.reshape(batch, -1),
                      z.reshape(batch, -1),
                      torch.ones((batch, height * width), dtype=depth.dtype,
                                 device=depth.device)], dim=1)
  return xyz1, feats.reshape(batch, -1, channels)


class Frame(NamedTuple):
  """One panorama in the memory: its semantic and its RGB cloud."""
  sem_xyz: torch.Tensor   # (1, 4, H*W)
  sem: torch.Tensor       # (1, H*W, 1)
  rgb_xyz: torch.Tensor   # (1, 4, P)
  rgb: torch.Tensor       # (1, P, 3)


def memory_frame(rgb: torch.Tensor, semantic: torch.Tensor,
                 depth: torch.Tensor, position: torch.Tensor,
                 depth_scale: float, pole_compact: bool) -> Frame:
  """What writing one panorama puts in the memory.

  rgb (1, H, W, 3) in [0, 255], semantic (1, H, W) classes, depth (1, H,
  W) in [0, 1], position (1, 3). The RGB is pole-masked first; with
  `pole_compact` the masked rows leave the RGB cloud.
  """
  rgb = mask_pano(rgb.to(torch.int32), INVALID_RGB_VALUE)
  offset = torch.cat([position.to(torch.float32),
                      torch.zeros_like(position[:, :1], dtype=torch.float32)],
                     dim=1)[:, :, None]
  sem_xyz, sem = unproject(semantic.to(torch.int32)[..., None], depth,
                           INVALID_SEM_VALUE, depth_scale)
  rgb_xyz, rgb_f = unproject(rgb.to(torch.float32), depth, INVALID_RGB_VALUE,
                             depth_scale)
  sem_xyz, rgb_xyz = sem_xyz + offset, rgb_xyz + offset
  height, width = depth.shape[1:]
  if pole_compact:
    r0, r1 = pole_valid_rows(height)
    rgb_xyz = rgb_xyz.reshape(1, 4, height, width)[:, :, r0:r1].reshape(
        1, 4, -1)
    rgb_f = rgb_f.reshape(1, height, width, 3)[:, r0:r1].reshape(1, -1, 3)
  return Frame(sem_xyz, sem.to(torch.float32), rgb_xyz, rgb_f)


def view_coords(xyz1: torch.Tensor) -> torch.Tensor:
  """(N, 4, M) camera-relative points -> equirect view coordinates."""
  x, y, z = xyz1[:, 0, :], xyz1[:, 1, :], xyz1[:, 2, :]
  dtype = xyz1.dtype
  rad = torch.sqrt(x * x + y * y + z * z)
  heading = torch.atan2(y, x)
  heading = 1.5 * math.pi - heading
  heading = heading + (2 * math.pi) * (heading <= 0).to(dtype)
  heading = heading - (2 * math.pi) * (heading > (2 * math.pi)).to(dtype)
  zero = rad == 0
  cos_elev = torch.where(zero, torch.zeros_like(z),
                         z / torch.where(zero, torch.ones_like(rad), rad))
  elevation = torch.arccos(torch.clamp(cos_elev, -1.0, 1.0))
  proj_x = rad * ((heading / divisor(2 * math.pi, heading)) * 2 - 1)
  proj_y = rad * ((elevation / divisor(math.pi, elevation)) * 2 - 1)
  return torch.stack([proj_x, proj_y, rad, torch.ones_like(proj_x)], dim=1)


def _pixel_index(f: torch.Tensor, size: int):
  t = torch.trunc(torch.nan_to_num(f, nan=0.0))
  ok = (t >= 0) & (t < size)
  return torch.where(ok, t, torch.zeros_like(t)).to(torch.int64), ok


def splat_fast(coords: torch.Tensor, feats: torch.Tensor, height: int,
               width: int, depth_scale: float, void: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The 'fast' splat of view coordinates (N, 4, M) and byte features
  (N, M, C), C <= 3: (depth (N, H, W) in [0, 1], features (N, H, W, C),
  0 where no point landed)."""
  batch, channels = coords.shape[0], feats.shape[-1]
  depth = coords[:, 2, :]
  safe = torch.where(depth == 0, torch.ones_like(depth), depth)
  view = torch.where(depth[:, None, :] == 0, torch.zeros_like(coords[:, 0:2]),
                     coords[:, 0:2, :] / safe[:, None, :])
  px, ok_x = _pixel_index((view[:, 0, :] + 1.0) / 2.0 * width, width)
  py, ok_y = _pixel_index((view[:, 1, :] + 1.0) / 2.0 * height, height)
  valid = ok_x & ok_y & (depth > 0) & torch.all(feats != void, dim=-1)
  pixels = height * width
  flat = torch.where(valid, py * width + px, torch.full_like(px, pixels))
  bucket = torch.clamp(depth / divisor(depth_scale, depth) * 255.0, 0.0,
                       255.0)
  key = (255 - torch.nan_to_num(bucket, nan=0.0).to(torch.int64)) << 24
  fbytes = torch.clamp(torch.nan_to_num(feats, nan=0.0), 0.0, 255.0).to(
      torch.int64)
  for c in range(channels):
    key = key | (fbytes[..., c] << (8 * (channels - 1 - c)))
  key = torch.where(valid, key, torch.zeros_like(flat))
  zbuf = torch.full((batch, pixels + 1), depth_scale, dtype=torch.float32,
                    device=coords.device)
  zbuf.scatter_reduce_(1, flat, depth.to(torch.float32), 'amin')
  words = torch.zeros((batch, pixels + 1), dtype=torch.int64,
                      device=coords.device)
  words.scatter_reduce_(1, flat, key, 'amax')
  zbuf, words = zbuf[:, :pixels], words[:, :pixels]
  depth_img = (torch.clamp(zbuf, 0.0, depth_scale)
               / divisor(depth_scale, zbuf)).reshape(batch, height, width)
  got = words != 0
  cols = [torch.where(got, ((words >> (8 * (channels - 1 - c))) & 0xFF).to(
      torch.float32), torch.zeros((), device=words.device))
          for c in range(channels)]
  return depth_img, torch.stack(cols, dim=-1).reshape(batch, height, width,
                                                      channels)


class Guidance(NamedTuple):
  """The guidance images of one view and the generator's inputs."""
  proj_semantic_u8: torch.Tensor  # (N, H, W)
  proj_rgb_u8: torch.Tensor       # (N, H, W, 3)
  proj_depth: torch.Tensor        # (N, H, W)
  proj_mask: torch.Tensor         # (N, H, W, 1)
  inputs: dict


def guidance(frames: List[Frame], sem_frames: List[Frame],
             positions: torch.Tensor, height: int, depth_scale: float
             ) -> Guidance:
  """The guidance that the memory of `frames` gives at each of
  `positions` (K, 3); `sem_frames` are the frames that hold real
  semantics (predicted frames hold none)."""
  width = 2 * height
  offsets = torch.cat([positions.to(torch.float32),
                       torch.zeros_like(positions[:, :1])], dim=1)[:, :, None]
  k = positions.shape[0]

  def splat(xyz, feats, void):
    xyz = torch.cat(xyz, dim=-1).expand(k, -1, -1)
    feats = torch.cat(feats, dim=1).expand(k, -1, -1)
    return splat_fast(view_coords(xyz - offsets), feats, height, width,
                      depth_scale, void)

  if sem_frames:
    _, proj_sem = splat([f.sem_xyz for f in sem_frames],
                        [f.sem for f in sem_frames], INVALID_SEM_VALUE)
  else:
    proj_sem = torch.zeros((k, height, width, 1), device=positions.device)
  proj_depth, proj_rgb = splat([f.rgb_xyz for f in frames],
                               [f.rgb for f in frames], INVALID_RGB_VALUE)
  proj_mask = ((proj_depth > 0) & (proj_depth < 1)
               & torch.all(proj_rgb != INVALID_RGB_VALUE, dim=-1)
               ).to(torch.float32)[..., None]
  proj_rgb_norm = torch.clamp(proj_rgb / divisor(255.0, proj_rgb), 0.0, 1.0)
  inputs = {'proj_image': proj_rgb_norm, 'proj_depth': proj_depth[..., None],
            'proj_mask': proj_mask,
            'blurred_mask': torch.zeros_like(proj_mask)}
  return Guidance(proj_sem[..., 0].to(torch.uint8),
                  (proj_rgb_norm * 255).to(torch.uint8), proj_depth,
                  proj_mask, inputs)


def served_outputs(depth_out: torch.Tensor, rgb_out: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The generator's (N, H, W, 1) depth and (N, H, W, 3) RGB in [0, 1] as
  served: (pred_rgb uint8, pred_depth float32 in [0, 1])."""
  pred_rgb = (torch.clamp(rgb_out, 0, 1) * 255).to(torch.int32)
  return (torch.clamp(pred_rgb, 0, 255).to(torch.uint8),
          torch.clamp(depth_out[..., 0], 0.0, 1.0))
