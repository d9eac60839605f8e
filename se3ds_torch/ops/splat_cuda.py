"""CUDA z-buffer splats: the Hopper counterparts of the TPU kernels of
`se3ds_tpu.ops.splat_pallas`.

`splat_fast` computes the two per-pixel buffers of the 'fast' splat:
the exact f32 minimum depth (initialised to depth_scale) and the u32
maximum of the packed key (initialised to 0). On a CUDA tensor it
launches the kernel of `csrc/splat.cu`, which replaces the TPU kernel
`_splat_kernel` (se3ds_tpu/ops/splat_pallas.py:87).

`splat_exact` computes the two per-pixel buffers of the exact 'scatter'
splat: the same minimum depth, then the per-channel f32 maximum of the
features of the points whose raw depth lies within 0.1 m of it
(initialised to output_void_class). On a CUDA tensor it launches the two
passes of `csrc/splat_exact.cu`, which replaces the TPU kernel
`_exact_splat_kernel` (se3ds_tpu/ops/splat_pallas.py:204).

On a CPU tensor each runs its plain version (`splat_fast_plain`,
`splat_exact_plain`), the same function in plain PyTorch. Kernel and
plain version give the same bits: min and max do not depend on the order
of the points.

`LAUNCHES` and `EXACT_LAUNCHES` count the launches of each source's
kernels in this process (`splat_exact` launches two per call).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import torch

from se3ds_torch.ops import cuda_build
from se3ds_torch.ops import splat as splat_lib

SOURCE = 'splat.cu'
EXACT_SOURCE = 'splat_exact.cu'
LAUNCHES = 0
EXACT_LAUNCHES = 0

_U32_MASK = 0xFFFFFFFF


def splat_fast_plain(coords: torch.Tensor, feats: torch.Tensor, height: int,
                     width: int, depth_scale: float, input_void_class: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of the kernel (any device).

  Args:
    coords: (B, 4, M) float32 view coordinates.
    feats: (B, M, C) float32 features, C <= 3.

  Returns:
    zbuf: (B, H*W) float32 minimum depth, depth_scale where empty.
    pbuf: (B, H*W) int64 holding the u32 maximum key, 0 where empty.
  """
  batch = coords.shape[0]
  num_pixels = height * width
  flat, depth, valid = splat_lib.pixel_coords(coords, feats, height, width,
                                              input_void_class)
  key = torch.where(valid, splat_lib.packed_keys(depth, feats, depth_scale),
                    torch.zeros_like(flat))
  # One extra column takes the invalid points' sentinel index.
  zbuf = torch.full((batch, num_pixels + 1), depth_scale, dtype=torch.float32,
                    device=coords.device)
  zbuf.scatter_reduce_(1, flat, depth.to(torch.float32), 'amin')
  pbuf = torch.zeros((batch, num_pixels + 1), dtype=torch.int64,
                     device=coords.device)
  pbuf.scatter_reduce_(1, flat, key, 'amax')
  return zbuf[:, :num_pixels], pbuf[:, :num_pixels]


# The C interface shared by the launchers: coords, feats, batch,
# num_points, coords_bstride, feats_bstride, channels, height, width.
_POINT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
               ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
               ctypes.c_int]
_ARGTYPES = {
    # depth_scale, void_value, zbuf, pbuf, stream
    'se3ds_splat_fast': _POINT_ARGS + [ctypes.c_float, ctypes.c_float,
                                       ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p],
    # void_value, zbuf, stream
    'se3ds_splat_exact_depth': _POINT_ARGS + [ctypes.c_float,
                                              ctypes.c_void_p,
                                              ctypes.c_void_p],
    # void_value, tolerance, zbuf, fbuf, stream
    'se3ds_splat_exact_feats': _POINT_ARGS + [ctypes.c_float,
                                              ctypes.c_float,
                                              ctypes.c_void_p,
                                              ctypes.c_void_p,
                                              ctypes.c_void_p],
}


def _library(source: str = SOURCE) -> ctypes.CDLL:
  lib = cuda_build.load(source)
  for name, argtypes in _ARGTYPES.items():
    fn = getattr(lib, name, None)
    if fn is not None and fn.argtypes is None:
      fn.argtypes = argtypes
      fn.restype = ctypes.c_int
  return lib


def check_inputs(coords: torch.Tensor, feats: torch.Tensor, height: int,
                 width: int, max_channels: Optional[int] = 3
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Validates a kernel's inputs; returns them with unit inner strides.

  `max_channels` is 3 for the 'fast' kernel, which packs feature bytes,
  and None for the exact kernel, which takes any number of channels.
  """
  if coords.dtype != torch.float32 or feats.dtype != torch.float32:
    raise TypeError(f'splat kernel takes float32 coords and feats, got '
                    f'{coords.dtype} and {feats.dtype}')
  if feats.device != coords.device:
    raise ValueError(f'coords on {coords.device}, feats on {feats.device}')
  batch, rows, num_points = coords.shape
  channels = feats.shape[-1]
  if (rows != 4 or feats.shape != (batch, num_points, channels)
      or channels < 1 or (max_channels and channels > max_channels)):
    raise ValueError(f'expected coords (B, 4, M) and feats (B, M, C) with '
                     f'1 <= C <= {max_channels or "any"}, got '
                     f'{tuple(coords.shape)} and {tuple(feats.shape)}')
  if height * width >= 2**31 or batch >= 2**16:
    raise ValueError(f'image {height}x{width} or batch {batch} too large')
  if coords.stride(2) != 1 or coords.stride(1) != num_points:
    coords = coords.contiguous()
  if feats.stride(2) != 1 or feats.stride(1) != channels:
    feats = feats.contiguous()
  return coords, feats


def launch_splat_fast(coords: torch.Tensor, feats: torch.Tensor,
                      height: int, width: int, depth_scale: float,
                      input_void_class: float, zbuf: torch.Tensor,
                      pbuf: torch.Tensor) -> None:
  """Launches the kernel into caller-initialised buffers.

  zbuf: (B, H*W) float32 filled with depth_scale; pbuf: (B, H*W) int32
  filled with 0 (it receives u32 bits). Inputs as `check_inputs` returns
  them. Runs on the current stream; raises if the launch is refused.
  """
  global LAUNCHES
  batch, _, num_points = coords.shape
  for buf, dtype in ((zbuf, torch.float32), (pbuf, torch.int32)):
    if (buf.dtype != dtype or buf.shape != (batch, height * width)
        or buf.device != coords.device or not buf.is_contiguous()):
      raise ValueError(f'buffer {buf.dtype} {tuple(buf.shape)} on '
                       f'{buf.device}; expected contiguous {dtype} '
                       f'({batch}, {height * width}) on {coords.device}')
  if not (batch and num_points):
    return
  lib = _library()
  with torch.cuda.device(coords.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.se3ds_splat_fast(
        coords.data_ptr(), feats.data_ptr(), batch, num_points,
        coords.stride(0), feats.stride(0), feats.shape[-1], height, width,
        float(depth_scale), float(input_void_class), zbuf.data_ptr(),
        pbuf.data_ptr(), stream)
  if err != 0:
    raise RuntimeError(f'splat kernel launch failed with CUDA error {err}')
  LAUNCHES += 1


def _splat_fast_cuda(coords: torch.Tensor, feats: torch.Tensor, height: int,
                     width: int, depth_scale: float, input_void_class: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  coords, feats = check_inputs(coords, feats, height, width)
  batch = coords.shape[0]
  zbuf = torch.full((batch, height * width), depth_scale,
                    dtype=torch.float32, device=coords.device)
  pbuf = torch.zeros((batch, height * width), dtype=torch.int32,
                     device=coords.device)
  launch_splat_fast(coords, feats, height, width, depth_scale,
                    input_void_class, zbuf, pbuf)
  return zbuf, pbuf.to(torch.int64) & _U32_MASK


def splat_fast(coords: torch.Tensor, feats: torch.Tensor, height: int,
               width: int, depth_scale: float, input_void_class: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Per-pixel (min depth, max packed key) buffers of the 'fast' splat.

  Launches the CUDA kernel for CUDA tensors (or raises); CPU tensors take
  `splat_fast_plain`. Same arguments and results as `splat_fast_plain`.
  """
  if coords.is_cuda:
    return _splat_fast_cuda(coords, feats, height, width, depth_scale,
                            input_void_class)
  return splat_fast_plain(coords, feats, height, width, depth_scale,
                          input_void_class)


# -- the exact splat ----------------------------------------------------------


def splat_exact_plain(coords: torch.Tensor, feats: torch.Tensor, height: int,
                      width: int, depth_scale: float, input_void_class: float,
                      output_void_class: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of the exact kernel (any device).

  Args:
    coords: (B, 4, M) float32 view coordinates.
    feats: (B, M, C) float32 features, any C >= 1.

  Returns:
    zbuf: (B, H*W) float32 minimum depth, depth_scale where empty.
    fbuf: (B, H*W, C) float32 per-channel maximum of the features of the
      points whose raw depth is < zbuf + 0.1 (f32), output_void_class
      where no point is.
  """
  batch, channels = coords.shape[0], feats.shape[-1]
  num_pixels = height * width
  flat, depth, valid = splat_lib.pixel_coords(coords, feats, height, width,
                                              input_void_class)
  depth = depth.to(torch.float32)
  # One extra column takes the invalid points' sentinel index.
  zbuf = torch.full((batch, num_pixels + 1), depth_scale, dtype=torch.float32,
                    device=coords.device)
  zbuf.scatter_reduce_(1, flat, depth, 'amin')
  tolerance = torch.full((), splat_lib.DEPTH_COLLISION_TOLERANCE,
                         dtype=torch.float32, device=coords.device)
  keep = valid & (depth < torch.gather(zbuf, 1, flat) + tolerance)
  flat_keep = torch.where(keep, flat, torch.full_like(flat, num_pixels))
  cols = []
  for c in range(channels):
    col = torch.full((batch, num_pixels + 1), output_void_class,
                     dtype=torch.float32, device=coords.device)
    col.scatter_reduce_(1, flat_keep, feats[..., c].to(torch.float32),
                        'amax', include_self=True)
    cols.append(col[:, :num_pixels])
  return zbuf[:, :num_pixels], torch.stack(cols, dim=-1)


def order_key(value: float) -> int:
  """The order-preserving u32 key of a float32 (the kernel's `order_key`),
  as the int32 with the same bits."""
  (bits,) = struct.unpack('<I', struct.pack('<f', value))
  key = (~bits & _U32_MASK) if bits & 0x80000000 else (bits | 0x80000000)
  return key - (1 << 32) if key >= 1 << 31 else key


def decode_order_keys(keys: torch.Tensor) -> torch.Tensor:
  """Float32 values of int32 tensors holding `order_key` bits."""
  bits = torch.where(keys < 0, keys & 0x7FFFFFFF, ~keys)
  return bits.view(torch.float32)


def launch_splat_exact(coords: torch.Tensor, feats: torch.Tensor,
                       height: int, width: int, input_void_class: float,
                       zbuf: torch.Tensor, fbuf: torch.Tensor) -> None:
  """Launches both passes into caller-initialised buffers.

  zbuf: (B, H*W) float32 filled with depth_scale; fbuf: (B, H*W, C) int32
  filled with `order_key(output_void_class)` (it receives u32 keys).
  Inputs as `check_inputs(..., max_channels=None)` returns them. Runs on
  the current stream; raises if a launch is refused.
  """
  global EXACT_LAUNCHES
  batch, _, num_points = coords.shape
  channels = feats.shape[-1]
  num_pixels = height * width
  for buf, dtype, shape in ((zbuf, torch.float32, (batch, num_pixels)),
                            (fbuf, torch.int32,
                             (batch, num_pixels, channels))):
    if (buf.dtype != dtype or buf.shape != shape
        or buf.device != coords.device or not buf.is_contiguous()):
      raise ValueError(f'buffer {buf.dtype} {tuple(buf.shape)} on '
                       f'{buf.device}; expected contiguous {dtype} '
                       f'{shape} on {coords.device}')
  if not (batch and num_points):
    return
  lib = _library(EXACT_SOURCE)
  args = (coords.data_ptr(), feats.data_ptr(), batch, num_points,
          coords.stride(0), feats.stride(0), channels, height, width,
          float(input_void_class))
  with torch.cuda.device(coords.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.se3ds_splat_exact_depth(*args, zbuf.data_ptr(), stream)
    if err != 0:
      raise RuntimeError(f'exact splat depth pass failed to launch with '
                         f'CUDA error {err}')
    EXACT_LAUNCHES += 1
    err = lib.se3ds_splat_exact_feats(
        *args, splat_lib.DEPTH_COLLISION_TOLERANCE, zbuf.data_ptr(),
        fbuf.data_ptr(), stream)
    if err != 0:
      raise RuntimeError(f'exact splat feature pass failed to launch with '
                         f'CUDA error {err}')
    EXACT_LAUNCHES += 1


def _splat_exact_cuda(coords: torch.Tensor, feats: torch.Tensor, height: int,
                      width: int, depth_scale: float, input_void_class: float,
                      output_void_class: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  coords, feats = check_inputs(coords, feats, height, width,
                               max_channels=None)
  batch, channels = coords.shape[0], feats.shape[-1]
  zbuf = torch.full((batch, height * width), depth_scale,
                    dtype=torch.float32, device=coords.device)
  fbuf = torch.full((batch, height * width, channels),
                    order_key(output_void_class), dtype=torch.int32,
                    device=coords.device)
  launch_splat_exact(coords, feats, height, width, input_void_class, zbuf,
                     fbuf)
  return zbuf, decode_order_keys(fbuf)


def splat_exact(coords: torch.Tensor, feats: torch.Tensor, height: int,
                width: int, depth_scale: float, input_void_class: float,
                output_void_class: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Per-pixel (min depth, windowed per-channel max) of the exact splat.

  Launches the two CUDA passes for CUDA tensors (or raises); CPU tensors
  take `splat_exact_plain`. Same arguments and results as
  `splat_exact_plain`.
  """
  if coords.is_cuda:
    return _splat_exact_cuda(coords, feats, height, width, depth_scale,
                             input_void_class, output_void_class)
  return splat_exact_plain(coords, feats, height, width, depth_scale,
                           input_void_class, output_void_class)
