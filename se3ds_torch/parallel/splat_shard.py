"""The memory splat with its point axis spread over a process group (port
of `se3ds_tpu.parallel.splat_shard`).

Each rank of the group splats its share of the points (a view of the
point axis: the memory is whole on every rank, and a stride-0 `expand`
stays one) into whole-image buffers, and the buffers combine over the
group by minimum and maximum. Both are associative and commutative, so
every rank gets images BIT-equal to the unsharded splat of the same mode:

  'fast'        the 'fast' point pass on the share, the words' unsigned
                minimum over the group, the resolve
                (`splat.project_to_feat_fast`);
  'scatter'     the exact splat in two passes: pass 1 on the share, the
                depth minima over the group, pass 2 against the GLOBAL
                minima, the feature words over the group, the resolve
                (`splat.project_to_feat`);
  'fast_exact'  the same two phases in PyTorch ops
                (`splat.project_to_feat_fast_exact`).

On CUDA tensors 'fast' and 'scatter' run the CUDA kernels' split entry
points (`splat_cuda.fast_words` / `fast_resolve`, `exact_pass` /
`exact_resolve`) and combine their u32 words with
`splat_cuda.all_reduce_unsigned_min`; on CPU tensors, and for
'fast_exact' on both, the plain buffers combine (float32 MIN, int64 MAX).
With more than 3 feature channels the packed modes run 'scatter', as the
unsharded ones run the exact splat. Each combine moves the whole image's
buffers, whatever the number of points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from se3ds_torch.ops import geometry
from se3ds_torch.ops import splat as splat_lib
from se3ds_torch.ops import splat_cuda

SHARDED_MODES = ('fast', 'fast_exact', 'scatter')


def point_share(num_points: int, size: int, rank: int) -> Tuple[int, int]:
  """[start, stop) of rank `rank`'s share of `num_points` over `size`
  ranks: balanced, any `num_points`."""
  return num_points * rank // size, num_points * (rank + 1) // size


def _all_reduce(tensor: torch.Tensor, op, group) -> torch.Tensor:
  """`tensor` reduced over `group`, as a contiguous copy where it is not
  contiguous (a collective reads the storage as one dense block)."""
  tensor = tensor.contiguous()
  dist.all_reduce(tensor, op=op, group=group)
  return tensor


def _plain_pass1(view, feats, height, width, void_class, depth_scale, group):
  """pixel_coords of the share and the GLOBAL minimum-depth buffer."""
  flat, depth, valid = splat_lib.pixel_coords(view, feats, height, width,
                                              void_class)
  zbuf = _all_reduce(splat_lib.min_depth_buffer(flat, depth, height * width,
                                                depth_scale),
                     dist.ReduceOp.MIN, group)
  return flat, depth, valid, zbuf


def _plain(splat_mode, feats, view, height, width, void_class, depth_scale,
           output_void_class, group):
  """The share's plain buffers, combined: (zbuf, features (N, P, C))."""
  num_pixels, channels = height * width, feats.shape[-1]
  if splat_mode == 'fast':
    zbuf, pbuf = splat_cuda.splat_fast_plain(view, feats, height, width,
                                             depth_scale, void_class)
    zbuf = _all_reduce(zbuf, dist.ReduceOp.MIN, group)
    pbuf = _all_reduce(pbuf, dist.ReduceOp.MAX, group)
    return zbuf, splat_lib.unpack_bytes(pbuf, channels, 0, feats.dtype,
                                        output_void_class)
  flat, depth, valid, zbuf = _plain_pass1(view, feats, height, width,
                                          void_class, depth_scale, group)
  keep = splat_lib.in_window(flat, depth, valid, zbuf)
  flat_keep = torch.where(keep, flat, torch.full_like(flat, num_pixels))
  if splat_mode == 'fast_exact':
    pbuf = splat_lib.scatter_max(
        torch.zeros_like(zbuf, dtype=torch.int64), flat_keep,
        1 + splat_lib.pack_bytes(feats, 1))
    pbuf = _all_reduce(pbuf, dist.ReduceOp.MAX, group)
    return zbuf, splat_lib.unpack_bytes(pbuf, channels, 1, feats.dtype,
                                        output_void_class)
  void = torch.full_like(zbuf, output_void_class, dtype=feats.dtype)
  fbuf = torch.stack([splat_lib.scatter_max(void, flat_keep, feats[..., c])
                      for c in range(channels)], dim=-1)
  return zbuf, _all_reduce(fbuf, dist.ReduceOp.MAX, group)


def _kernels(splat_mode, feats, xyz1, offset, height, width, void_class,
             depth_scale, output_void_class, need_depth, group):
  """The share through the CUDA kernels' split entry points, combined:
  (depth (N, P) in [0, 1] or None, features (N, P, C))."""
  if splat_mode == 'fast':
    words = splat_cuda.fast_words(xyz1, feats, height, width, depth_scale,
                                  void_class, offset=offset,
                                  need_depth=need_depth)
    return splat_cuda.fast_resolve(
        splat_cuda.all_reduce_unsigned_min(words, group), feats.shape[-1],
        depth_scale, output_void_class)
  words = splat_cuda.exact_pass(xyz1, feats, height, width, depth_scale,
                                void_class, 1, offset=offset)
  minima = splat_cuda.all_reduce_unsigned_min(words[..., 0].contiguous(),
                                              group)
  words[..., 0] = minima
  words = splat_cuda.exact_pass(xyz1, feats, height, width, depth_scale,
                                void_class, 2, words=words, offset=offset)
  return splat_cuda.exact_resolve(
      splat_cuda.all_reduce_unsigned_min(words, group), depth_scale,
      output_void_class, need_depth=need_depth)


def project_memory_equirect_sharded(
    feats: torch.Tensor,
    xyz1: torch.Tensor,
    offset: torch.Tensor,
    height: int,
    width: int,
    void_class: float,
    depth_scale: float,
    *,
    group=None,
    splat_mode: str = 'fast',
    need_depth: bool = True,
    output_void_class: float = 0.0,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
  """`geometry.project_memory_equirect` with the point axis spread over
  `group` (default: the whole world). Every rank of the group calls it
  with the same whole memory and gets the same whole images.

  Args:
    feats: (N, M) or (N, M, C) point features (any batch stride).
    xyz1: (N, 4, M) world points (any row and batch stride).
    offset: (N, 4) or (1, 4) camera positions, homogeneous w = 0.
    group: the process group whose ranks share the points.
    splat_mode: 'fast', 'fast_exact' or 'scatter'.
    need_depth: False returns None for the depth.

  Returns:
    (depth (N, H, W) in [0, 1] or None, features (N, H, W[, C])).
  """
  if splat_mode not in SHARDED_MODES:
    raise ValueError(f'Unsupported sharded splat_mode {splat_mode!r}; use '
                     f'one of {SHARDED_MODES}.')
  feats, is_scalar_feat = splat_lib.feats_3d(feats)
  feats = feats.to(xyz1.dtype)
  batch, channels = xyz1.shape[0], feats.shape[-1]
  if channels > splat_lib.MAX_PACKED_CHANNELS:
    splat_mode = 'scatter'
  start, stop = point_share(xyz1.shape[-1], dist.get_world_size(group),
                            dist.get_rank(group))
  share = feats[:, start:stop]
  if xyz1.is_cuda and splat_mode != 'fast_exact':
    depth, feat = _kernels(splat_mode, share, xyz1[:, :, start:stop], offset,
                           height, width, void_class, depth_scale,
                           output_void_class, need_depth, group)
  else:
    # The view coordinates of the whole cloud, then the share's: PyTorch's
    # CPU kernels can round the tail of a vector loop otherwise than its
    # body, so the share's own coordinates could move by an ULP.
    view = geometry.equirect_view_coords(xyz1 - offset[..., None])
    zbuf, feat = _plain(splat_mode, share, view[..., start:stop], height,
                        width, void_class, depth_scale, output_void_class,
                        group)
    depth = splat_lib.depth_image(zbuf, depth_scale, height, width)
  if depth is not None:
    depth = depth.reshape(batch, height, width) if need_depth else None
  feat = feat.reshape(batch, height, width, channels)
  return depth, feat[..., 0] if is_scalar_feat else feat


def project_feats_to_equirectangular_sharded(
    feats: torch.Tensor,
    xyz1: torch.Tensor,
    height: int,
    width: int,
    void_class: float,
    depth_scale: float,
    *,
    mesh,
    axis: str = 'data',
    splat_mode: str = 'fast',
    output_void_class: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Sharded `geometry.project_feats_to_equirectangular` (the JAX
  function's arguments): the points spread over the `axis` group of the
  `DeviceMesh` `mesh`, at a zero camera offset."""
  offset = torch.zeros((1, 4), dtype=xyz1.dtype, device=xyz1.device)
  return project_memory_equirect_sharded(
      feats, xyz1, offset, height, width, void_class, depth_scale,
      group=mesh.get_group(axis), splat_mode=splat_mode,
      output_void_class=output_void_class)
