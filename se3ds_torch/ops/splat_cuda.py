"""CUDA z-buffer splats: the Hopper counterparts of the TPU kernels of
`se3ds_tpu.ops.splat_pallas`.

Each source has a point pass and a per-pixel resolve:

- `csrc/splat.cu` (the 'fast' splat, replacing the TPU kernel
  `_splat_kernel`, se3ds_tpu/ops/splat_pallas.py:87): `fast_words` folds
  every point into a per-pixel u32 word pair (min depth bits, min of the
  complemented packed key), `fast_resolve` turns the words into the depth
  and feature images of `splat.project_to_feat_fast`.
- `csrc/splat_exact.cu` (the exact 'scatter' splat, replacing
  `_exact_splat_kernel`, :204): `exact_words` runs both passes in one
  cooperative launch into 1 + C words per pixel (min depth bits, then the
  min of the complemented order keys of the features in the window),
  `exact_resolve` writes the images of `splat.project_to_feat`.
  `exact_pass` runs one pass alone (an ordinary launch), for a splat
  whose minima are combined across ranks between the passes
  (`parallel.splat_shard`).

The point passes take either view coordinates (`offset=None`) or world
points and a (B, 4) camera offset, whose equirect view coordinates they
compute in registers (the main path: no translated or view tensor is
written). These functions take CUDA tensors only; `splat.splat_images`
and `geometry.project_memory_equirect` dispatch to them.

`splat_fast` and `splat_exact` return the plain versions' per-pixel
buffers (`splat_fast_plain`, `splat_exact_plain`): on a CUDA tensor from
the kernel's words, on a CPU tensor from the plain version. Kernel and
plain version give the same bits: min and max do not depend on the order
of the points.

The counters `splat.fast_launches` and `splat.exact_launches` of
`se3ds_torch.tracing` count the point-pass launches of each source in
this process (one per call of `fast_words`, `exact_words` or
`exact_pass`; resolves are not counted).

The words are u32 held in int32 tensors and combine by UNSIGNED minimum
(0xFFFFFFFF, -1 as int32, is "no point"); `all_reduce_unsigned_min`
combines them over a process group, whose MIN is signed.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import torch

from se3ds_torch import tracing
from se3ds_torch.ops import cuda_build
from se3ds_torch.ops import splat as splat_lib

SOURCE = 'splat.cu'
EXACT_SOURCE = 'splat_exact.cu'

_U32_MASK = 0xFFFFFFFF

# The point interface shared by the point passes: xyz, row_stride,
# batch_stride, offset, feats, feats_bstride, batch, num_points, channels,
# height, width, depth_scale, void_value.
_POINT_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
               ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_float, ctypes.c_float]
_ARGTYPES = {
    # need_depth, words, stream
    'se3ds_splat_fast': _POINT_ARGS + [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p],
    # words, num_pixels, channels, need_depth, depth_scale, out_void,
    # depth, feat, stream
    'se3ds_splat_fast_resolve': [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p],
    # tolerance, words, stream
    'se3ds_splat_exact': _POINT_ARGS + [ctypes.c_float, ctypes.c_void_p,
                                        ctypes.c_void_p],
    # tolerance, pass, words, stream
    'se3ds_splat_exact_pass': _POINT_ARGS + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p,
                                             ctypes.c_void_p],
    # words, num_pixels, channels, depth_scale, void_key, depth, feat,
    # stream
    'se3ds_splat_exact_resolve': [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_float,
                                  ctypes.c_uint32, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p],
}


_FUNCTIONS = {}


def _call(source: str, name: str, *args) -> None:
  """Calls a launcher of csrc/<source> on the current stream; raises on a
  CUDA error. The library is built at first use."""
  fn = _FUNCTIONS.get(name)
  if fn is None:
    fn = getattr(cuda_build.load(source), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    _FUNCTIONS[name] = fn
  err = fn(*args, torch.cuda.current_stream().cuda_stream)
  if err != 0:
    raise RuntimeError(f'{name} failed with CUDA error {err}')


def check_inputs(points: torch.Tensor, feats: torch.Tensor, height: int,
                 width: int, max_channels: Optional[int] = 3,
                 offset: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
  """Validates a point pass's inputs; returns them as the kernels read
  them: points with unit stride along the points (any row and batch
  stride), feats with unit inner strides, offset as (B, 4) contiguous.

  `max_channels` is 3 for the 'fast' kernel, which packs feature bytes,
  and None for the exact kernel, which takes any number of channels.
  """
  if points.dtype != torch.float32 or feats.dtype != torch.float32:
    raise TypeError(f'splat kernel takes float32 points and feats, got '
                    f'{points.dtype} and {feats.dtype}')
  if not points.is_cuda or feats.device != points.device:
    raise ValueError(f'splat kernel takes CUDA tensors on one device, got '
                     f'points on {points.device}, feats on {feats.device}')
  batch, rows, num_points = points.shape
  channels = feats.shape[-1]
  if (rows != 4 or feats.shape != (batch, num_points, channels)
      or channels < 1 or (max_channels and channels > max_channels)):
    raise ValueError(f'expected points (B, 4, M) and feats (B, M, C) with '
                     f'1 <= C <= {max_channels or "any"}, got '
                     f'{tuple(points.shape)} and {tuple(feats.shape)}')
  if height * width >= 2**31 or batch >= 2**16:
    raise ValueError(f'image {height}x{width} or batch {batch} too large')
  if points.stride(2) != 1:
    points = points.contiguous()
  if feats.stride(2) != 1 or feats.stride(1) != channels:
    feats = feats.contiguous()
  if offset is not None:
    if offset.shape[-1] != 4 or offset.shape[0] not in (1, batch):
      raise ValueError(f'offset must be (B, 4) or (1, 4) for batch {batch},'
                       f' got {tuple(offset.shape)}')
    offset = offset.to(points.device, torch.float32).expand(
        batch, 4).contiguous()
  return points, feats, offset


def _point_args(points, feats, offset, height, width, depth_scale,
                input_void_class):
  batch, _, num_points = points.shape
  return (points.data_ptr(), points.stride(1), points.stride(0),
          offset.data_ptr() if offset is not None else None,
          feats.data_ptr(), feats.stride(0), batch, num_points,
          feats.shape[-1], height, width, float(depth_scale),
          float(input_void_class))


def _empty_words(shape, device) -> torch.Tensor:
  return torch.full(shape, -1, dtype=torch.int32, device=device)


# -- the 'fast' splat ---------------------------------------------------------


def splat_fast_plain(coords: torch.Tensor, feats: torch.Tensor, height: int,
                     width: int, depth_scale: float, input_void_class: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of the 'fast' point pass (any device).

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


def fast_words(points: torch.Tensor, feats: torch.Tensor, height: int,
               width: int, depth_scale: float, input_void_class: float,
               offset: Optional[torch.Tensor] = None,
               need_depth: bool = True) -> torch.Tensor:
  """The 'fast' point pass (CUDA tensors): a memset and one launch.

  Args:
    points: (B, 4, M) float32, view coordinates when `offset` is None,
      else world points whose view is taken from `offset`.
    feats: (B, M, C) float32, C <= 3.
    offset: None or (B, 4) / (1, 4) float32 camera positions (w ignored).
    need_depth: False leaves out the depth words and their atomics.

  Returns:
    (B, H*W, 2) int32 words (u32 depth bits, u32 ~key) with `need_depth`,
    else (B, H*W) int32 ~key words; 0xFFFFFFFF (-1) where empty.
  """
  points, feats, offset = check_inputs(points, feats, height, width,
                                       offset=offset)
  batch, _, num_points = points.shape
  shape = (batch, height * width) + ((2,) if need_depth else ())
  if not (batch and num_points):
    return _empty_words(shape, points.device)
  words = torch.empty(shape, dtype=torch.int32, device=points.device)
  with torch.cuda.device(points.device):
    _call(SOURCE, 'se3ds_splat_fast',
          *_point_args(points, feats, offset, height, width, depth_scale,
                       input_void_class), int(need_depth), words.data_ptr())
  tracing.counter('splat.fast_launches')
  return words


def fast_resolve(words: torch.Tensor, channels: int, depth_scale: float,
                 output_void_class: float
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
  """The 'fast' resolve (CUDA): `fast_words` -> (depth (B, H*W) in
  [0, 1], or None when the words hold no depth; features (B, H*W, C)
  float32, output_void_class where no point is)."""
  need_depth = words.dim() == 3
  batch, num_pixels = words.shape[:2]
  feat = torch.empty((batch, num_pixels, channels), dtype=torch.float32,
                     device=words.device)
  depth = (torch.empty((batch, num_pixels), dtype=torch.float32,
                       device=words.device) if need_depth else None)
  with torch.cuda.device(words.device):
    _call(SOURCE, 'se3ds_splat_fast_resolve', words.data_ptr(),
          batch * num_pixels, channels, int(need_depth), float(depth_scale),
          float(output_void_class),
          depth.data_ptr() if need_depth else None, feat.data_ptr())
  return depth, feat


def splat_fast(coords: torch.Tensor, feats: torch.Tensor, height: int,
               width: int, depth_scale: float, input_void_class: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Per-pixel (min depth, max packed key) buffers of the 'fast' splat.

  CUDA tensors go through the kernel's point pass (`fast_words`) and
  are read off its words; CPU tensors take `splat_fast_plain`. Same
  arguments and results as `splat_fast_plain`.
  """
  if not coords.is_cuda:
    return splat_fast_plain(coords, feats, height, width, depth_scale,
                            input_void_class)
  words = fast_words(coords, feats, height, width, depth_scale,
                     input_void_class)
  scale = torch.full((), depth_scale, device=words.device)
  # fmin reads the empty words' NaN bits as depth_scale.
  zbuf = torch.fmin(words[..., 0].view(torch.float32), scale)
  return zbuf, (~words[..., 1]).to(torch.int64) & _U32_MASK


# -- the exact splat ----------------------------------------------------------


def splat_exact_plain(coords: torch.Tensor, feats: torch.Tensor, height: int,
                      width: int, depth_scale: float, input_void_class: float,
                      output_void_class: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of the exact splat's passes (any device).

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


def exact_words(points: torch.Tensor, feats: torch.Tensor, height: int,
                width: int, depth_scale: float, input_void_class: float,
                offset: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Both passes of the exact splat (CUDA tensors): a memset and one
  cooperative launch.

  Args as `fast_words` (any C >= 1). Returns (B, H*W, 1 + C) int32 words:
  u32 min depth bits, then the u32 min of ~order_key(feature) over the
  window per channel; 0xFFFFFFFF (-1) where empty.
  """
  points, feats, offset = check_inputs(points, feats, height, width,
                                       max_channels=None, offset=offset)
  batch, _, num_points = points.shape
  shape = (batch, height * width, 1 + feats.shape[-1])
  if not (batch and num_points):
    return _empty_words(shape, points.device)
  words = torch.empty(shape, dtype=torch.int32, device=points.device)
  with torch.cuda.device(points.device):
    _call(EXACT_SOURCE, 'se3ds_splat_exact',
          *_point_args(points, feats, offset, height, width, depth_scale,
                       input_void_class),
          splat_lib.DEPTH_COLLISION_TOLERANCE, words.data_ptr())
  tracing.counter('splat.exact_launches')
  return words


def exact_pass(points: torch.Tensor, feats: torch.Tensor, height: int,
               width: int, depth_scale: float, input_void_class: float,
               pass_: int, words: Optional[torch.Tensor] = None,
               offset: Optional[torch.Tensor] = None) -> torch.Tensor:
  """One pass of the exact splat (CUDA tensors), an ordinary launch.

  Pass 1 makes the words (a memset, then the depth minima into word 0);
  pass 2 folds the window's features into words 1..C of `words`, testing
  each point against word 0 as it stands (the minima of every rank after
  `all_reduce_unsigned_min`). Args as `exact_words`; returns the words.
  """
  if pass_ not in (1, 2) or (pass_ == 2) != (words is not None):
    raise ValueError('pass 1 makes the words, pass 2 takes them')
  points, feats, offset = check_inputs(points, feats, height, width,
                                       max_channels=None, offset=offset)
  batch, _, num_points = points.shape
  shape = (batch, height * width, 1 + feats.shape[-1])
  if words is None:
    words = (_empty_words(shape, points.device) if not (batch and num_points)
             else torch.empty(shape, dtype=torch.int32, device=points.device))
  elif words.shape != shape or words.dtype != torch.int32 or (
      not words.is_contiguous()):
    raise ValueError(f'pass 2 takes the contiguous int32 words {shape} of '
                     f'pass 1, got {tuple(words.shape)} {words.dtype}')
  if not (batch and num_points):
    return words
  with torch.cuda.device(points.device):
    _call(EXACT_SOURCE, 'se3ds_splat_exact_pass',
          *_point_args(points, feats, offset, height, width, depth_scale,
                       input_void_class),
          splat_lib.DEPTH_COLLISION_TOLERANCE, pass_, words.data_ptr())
  tracing.counter('splat.exact_launches')
  return words


_SIGN_BIT = -2**31  # 0x80000000 as an int32


def all_reduce_unsigned_min(words: torch.Tensor, group=None) -> torch.Tensor:
  """The elementwise UNSIGNED minimum of contiguous int32 `words` over
  `group`, in place. Flipping the sign bit maps unsigned order onto
  signed order, which the group's MIN takes."""
  import torch.distributed as dist

  if words.dtype != torch.int32 or not words.is_contiguous():
    raise ValueError(f'contiguous int32 words, got {words.dtype}')
  flip = torch.full((), _SIGN_BIT, dtype=torch.int32, device=words.device)
  words.bitwise_xor_(flip)
  dist.all_reduce(words, op=dist.ReduceOp.MIN, group=group)
  return words.bitwise_xor_(flip)


def exact_resolve(words: torch.Tensor, depth_scale: float,
                  output_void_class: float, need_depth: bool = True
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
  """The exact resolve (CUDA): `exact_words` -> (depth (B, H*W) in
  [0, 1] or None, features (B, H*W, C) float32)."""
  batch, num_pixels, stride = words.shape
  feat = torch.empty((batch, num_pixels, stride - 1), dtype=torch.float32,
                     device=words.device)
  depth = (torch.empty((batch, num_pixels), dtype=torch.float32,
                       device=words.device) if need_depth else None)
  with torch.cuda.device(words.device):
    _call(EXACT_SOURCE, 'se3ds_splat_exact_resolve', words.data_ptr(),
          batch * num_pixels, stride - 1, float(depth_scale),
          order_key(output_void_class) & _U32_MASK,
          depth.data_ptr() if need_depth else None, feat.data_ptr())
  return depth, feat


def splat_exact(coords: torch.Tensor, feats: torch.Tensor, height: int,
                width: int, depth_scale: float, input_void_class: float,
                output_void_class: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Per-pixel (min depth, windowed per-channel max) of the exact splat.

  CUDA tensors go through the kernel's passes (`exact_words`) and are
  read off its words; CPU tensors take `splat_exact_plain`. Same
  arguments and results as `splat_exact_plain`.
  """
  if not coords.is_cuda:
    return splat_exact_plain(coords, feats, height, width, depth_scale,
                             input_void_class, output_void_class)
  words = exact_words(coords, feats, height, width, depth_scale,
                      input_void_class)
  scale = torch.full((), depth_scale, device=words.device)
  zbuf = torch.fmin(words[..., 0].view(torch.float32), scale)
  keys = torch.clamp((~words[..., 1:]).to(torch.int64) & _U32_MASK,
                     min=order_key(output_void_class) & _U32_MASK)
  return zbuf, decode_order_keys(keys.to(torch.int32))
