"""Data-parallel training across processes (port of
`se3ds_tpu.parallel.mesh`).

The JAX package trains data-parallel by construction: one 'data' mesh
axis, batches sharded on it, parameters replicated, and under GSPMD the
gradient means, the global BatchNorm statistics and ZeRO-1 (the Adam
moments and the EMA copy sharded over the axis) follow from the
shardings. The port says the same in PyTorch's idiom: one process per
card (`torchrun`), a `torch.distributed` process group (NCCL on the card,
gloo on the CPU) and each rank's slice of every batch.

* `init_from_env`: the group torchrun's environment describes
  (`WORLD_SIZE`, `RANK`, `LOCAL_RANK`); without `WORLD_SIZE`, world 1,
  the JAX mesh of one device. No fallback: a group that does not form
  raises.
* `DataParallel.average`: gradient means by bucketed `all_reduce`, before
  the per-tensor clip (the JAX gradients are global means when clipped).
  `DistributedDataParallel` is not used: its reducer hooks `.backward()`,
  and the train step differentiates with `torch.autograd.grad`.
* Global BatchNorm statistics: `models.layers.SyncBatchNorm`.
* ZeRO-1: `zero1_axis` is `shard_leaf_zero1`'s rule (the largest axis
  divisible by the world size), taken in the Flax layout of each tensor
  so that both packages shard the same axis; `Zero1Adam` keeps Adam's
  moments for this rank's shards only, updates them and all-gathers the
  parameters; the EMA generator holds only its shards
  (`DataParallel.shard_module_`). At world 1 nothing is sharded.
* Checkpoints: `Zero1Adam.state_dict` and `DataParallel.gather_state_dict`
  consolidate the shards on rank 0 into the bundle a world-1 run writes.
* Serving: `create_mesh` arranges the group's ranks as JAX's ('data',
  'spatial') mesh, a `DeviceMesh`: `SE3DSModel(mesh=...)` spreads the
  splat's points over 'data' (`parallel.splat_shard`) and the
  generator's rows over 'spatial' (`models.spatial`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed import device_mesh

from se3ds_torch import device as device_lib
from se3ds_torch.models import layers

BUCKET_BYTES = 32 * 2**20

# Port layout -> Flax layout: Flax axis j is port axis ORDER[j].
# Conv kernels are OIHW here and HWIO there; transposed-conv kernels are
# (in, out, kh, kw) here and (kh, kw, in, out) there (folding.py).
_CONV_ORDER = (2, 3, 1, 0)
_CONV_TRANSPOSE_ORDER = (2, 3, 0, 1)


def init_from_env(device: torch.device) -> torch.device:
  """Joins the data-parallel process group; returns this rank's device.

  A group already initialised (a caller that chose its own
  `init_method`, such as a `file://` one) is used as it is. Otherwise
  `WORLD_SIZE` in the environment (torchrun sets it with `RANK`,
  `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`) forms one by 'env://',
  NCCL for a CUDA device and gloo for the CPU; without it the process is
  world 1 and no group forms. On the card the rank's device is
  cuda:LOCAL_RANK, and a group that is not NCCL raises.
  """
  if not dist.is_initialized():
    if 'WORLD_SIZE' not in os.environ:
      return device
    dist.init_process_group(
        backend='nccl' if device.type == 'cuda' else 'gloo',
        init_method='env://', world_size=int(os.environ['WORLD_SIZE']),
        rank=int(os.environ['RANK']))
  if device.type == 'cuda':
    if dist.get_backend() != 'nccl':
      raise RuntimeError(f'a {dist.get_backend()} process group on the card;'
                         ' training on CUDA devices needs NCCL')
    device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    torch.cuda.set_device(device)
  return device


def create_mesh(num_data: Optional[int] = None, num_spatial: int = 1,
                device=None) -> device_mesh.DeviceMesh:
  """A (data, spatial) `DeviceMesh` over the process group's ranks (JAX
  `mesh.create_mesh`): rank r at (r // num_spatial, r % num_spatial).

  The group is `init_from_env`'s (NCCL on the card, gloo on the CPU): a
  caller's own, or torchrun's. `device` is where this rank runs ('cuda'
  by default; 'cpu' for gloo). `num_data` defaults to the world size over
  `num_spatial`; a shape whose size is not the world size raises
  ValueError, as the JAX mesh does for the device count.
  """
  device = init_from_env(device_lib.resolve(device, 'create_mesh'))
  if not dist.is_initialized():
    raise RuntimeError('create_mesh needs a torch.distributed process '
                       'group: run under torchrun or initialise one first')
  world = dist.get_world_size()
  if num_data is None:
    num_data = world // num_spatial
  if num_data * num_spatial != world:
    raise ValueError(f'mesh {num_data}x{num_spatial} != {world} ranks')
  return device_mesh.DeviceMesh(
      device.type, torch.arange(world).reshape(num_data, num_spatial),
      mesh_dim_names=('data', 'spatial'))


def zero1_axis(shape: Sequence[int], num_data: int) -> Optional[int]:
  """`shard_leaf_zero1`'s axis for a tensor of `shape` (in the Flax
  layout): the largest axis divisible by `num_data`, the first of equal
  ones; None replicates."""
  best = None
  for i, s in enumerate(shape):
    if s >= num_data and s % num_data == 0:
      if best is None or s > shape[best]:
        best = i
  return best


def param_axes(module: nn.Module, num_data: int) -> Dict[str, Optional[int]]:
  """The ZeRO-1 axis of each parameter of `module` (port layout), chosen
  by `zero1_axis` in the Flax layout of the same parameter."""
  axes = {}
  for prefix, owner in module.named_modules():
    for name, param in owner.named_parameters(recurse=False):
      order = tuple(range(param.dim()))
      if param.dim() == 4:
        order = (_CONV_TRANSPOSE_ORDER
                 if isinstance(owner, layers.Conv2DTranspose) else _CONV_ORDER)
      axis = zero1_axis([param.shape[i] for i in order], num_data)
      axes[f'{prefix}.{name}' if prefix else name] = (
          None if axis is None else order[axis])
  return {name: axes[name] for name, _ in module.named_parameters()}


@dataclasses.dataclass(frozen=True)
class DataParallel:
  """This process's place on the data axis: `world_size` ranks, this one
  `rank`. Its collectives run on the default process group; with none
  initialised it is world 1 (a larger world then raises, so a state
  built for accounting at world 8 never trains as if alone)."""
  world_size: int = 1
  rank: int = 0

  @classmethod
  def current(cls) -> 'DataParallel':
    """The initialised process group's world, or world 1 without one."""
    if dist.is_initialized():
      return cls(dist.get_world_size(), dist.get_rank())
    return cls()

  @property
  def is_chief(self) -> bool:
    """Rank 0 writes checkpoints, logs, events and image grids."""
    return self.rank == 0

  def _collective(self) -> bool:
    if dist.is_initialized():
      return True
    if self.world_size > 1:
      raise RuntimeError(f'world size {self.world_size} without a process '
                         'group')
    return False

  def barrier(self) -> None:
    if self._collective():
      dist.barrier()

  def axes(self, module: nn.Module) -> List[Optional[int]]:
    """The ZeRO-1 axis of each of `module`'s parameters (None: whole on
    every rank; everything at world 1)."""
    if self.world_size == 1:
      return [None] * len(list(module.parameters()))
    return list(param_axes(module, self.world_size).values())

  def shard(self, tensor: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """This rank's slice of `tensor` along `axis` (a view)."""
    if axis is None:
      return tensor
    size = tensor.shape[axis] // self.world_size
    return tensor.narrow(axis, self.rank * size, size)

  @torch.no_grad()
  def gather(self, shard: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """Every rank's `shard` concatenated along `axis` (all_gather)."""
    if axis is None or not self._collective():
      return shard
    shard = shard.contiguous()
    parts = [torch.empty_like(shard) for _ in range(self.world_size)]
    dist.all_gather(parts, shard)
    return torch.cat(parts, dim=axis)

  @torch.no_grad()
  def average(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's mean over the ranks, in place, by `all_reduce` of
    flat buckets of about BUCKET_BYTES; a no-op without a group."""
    if not tensors or not self._collective():
      return tensors
    bucket: List[torch.Tensor] = []
    size = 0
    for i, tensor in enumerate(tensors):
      bucket.append(tensor)
      size += tensor.numel() * tensor.element_size()
      if size >= BUCKET_BYTES or i == len(tensors) - 1:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(self.world_size)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
          t.copy_(part.view_as(t))
        bucket, size = [], 0
    return tensors

  @torch.no_grad()
  def shard_module_(self, module: nn.Module,
                    axes: Sequence[Optional[int]]) -> None:
    """Replaces each of `module`'s parameters with a copy of this rank's
    shard (the ZeRO-1 EMA); the buffers stay whole."""
    for param, axis in zip(module.parameters(), axes):
      if axis is not None:
        param.data = self.shard(param.data, axis).clone()

  def gather_state_dict(self, module: nn.Module,
                        axes: Sequence[Optional[int]],
                        every_rank: bool = False
                        ) -> Optional[Dict[str, torch.Tensor]]:
    """The whole state_dict of a module sharded by `shard_module_`:
    on rank 0 (each gathered tensor moved to the host), None elsewhere;
    with `every_rank`, on every rank (on the module's device). At world 1
    it is the module's own state_dict."""
    if self.world_size == 1:
      return module.state_dict()
    sharded = {name: axis for (name, _), axis in
               zip(module.named_parameters(), axes)}
    keep = every_rank or self.is_chief
    out = {}
    for name, tensor in module.state_dict().items():
      full = self.gather(tensor, sharded.get(name))
      out[name] = full if every_rank else full.cpu() if keep else None
    return out if keep else None

  def share(self, size: int) -> slice:
    """This rank's rows of `size` rows split in rank order (balanced, any
    size; a rank may get none)."""
    return slice(size * self.rank // self.world_size,
                 size * (self.rank + 1) // self.world_size)

  def gather_rows(self, arrays: Dict[str, list]
                  ) -> Optional[Dict[str, list]]:
    """Every rank's {key: [array per batch]} on rank 0, each batch's rows
    concatenated in rank order (None for a rank without rows); None on
    the other ranks. At world 1 it is `arrays`."""
    if self.world_size == 1:
      return arrays
    everyone = [None] * self.world_size if self.is_chief else None
    dist.gather_object(arrays, everyone, dst=0)
    if not self.is_chief:
      return None
    return {key: [np.concatenate([r[key][j] for r in everyone
                                  if r[key][j] is not None], 0)
                  for j in range(len(arrays[key]))] for key in arrays}

  def broadcast(self, value):
    """Rank 0's `value` (any picklable object) on every rank."""
    if self.world_size == 1:
      return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]

  def shard_state_dict(self, state_dict: Dict[str, torch.Tensor],
                       module: nn.Module, axes: Sequence[Optional[int]]
                       ) -> Dict[str, torch.Tensor]:
    """A whole state_dict cut to this rank's shards of `module`'s
    sharded parameters, for `module.load_state_dict`."""
    sharded = {name: axis for (name, _), axis in
               zip(module.named_parameters(), axes)}
    return {name: self.shard(t, sharded.get(name))
            for name, t in state_dict.items()}

  def local_batch(self, batch, num_chunks: int):
    """This rank's slice of each of the `num_chunks` chunks of a global
    batch (axis 0 of every array): every chunk is spread over the ranks,
    as the JAX mesh shards it."""
    if self.world_size == 1:
      return batch
    out = {}
    for key, value in batch.items():
      chunks = value.reshape(num_chunks, -1, *value.shape[1:])
      share = chunks.shape[1] // self.world_size
      if share * self.world_size != chunks.shape[1]:
        raise ValueError(f'{key}: a chunk of {chunks.shape[1]} does not '
                         f'split over {self.world_size} ranks')
      out[key] = chunks[:, self.rank * share:(self.rank + 1) * share].reshape(
          -1, *value.shape[1:])
    return out


class Zero1Adam:
  """`torch.optim.Adam` over this rank's ZeRO-1 shards of `module`'s
  parameters.

  A sharded parameter is stepped through a view of its rank's slice, so
  the moments are held for that slice only; after the step the slices
  are all-gathered into the parameters. A parameter without an axis
  (all of them at world 1) is stepped whole on every rank, as the JAX
  package replicates it. The Adam state is made at construction, as
  optax's `init` makes it. `state_dict` consolidates: at world 1 it is
  Adam's own, at a larger world the same format on rank 0 (moments
  gathered to the host) and None elsewhere; `load_state_dict` takes that
  format on every rank.
  """

  def __init__(self, module: nn.Module, data: DataParallel, **adam_kwargs):
    self.data = data
    self.params = list(module.parameters())
    self.axes = data.axes(module)
    self.shards = [p if a is None else nn.Parameter(data.shard(p.detach(), a))
                   for p, a in zip(self.params, self.axes)]
    self.optimizer = torch.optim.Adam(self.shards, **adam_kwargs)
    for shard in self.shards:
      self.optimizer.state[shard] = {
          'step': torch.tensor(0.0, dtype=torch.float32),
          'exp_avg': torch.zeros_like(shard,
                                      memory_format=torch.preserve_format),
          'exp_avg_sq': torch.zeros_like(shard,
                                         memory_format=torch.preserve_format)}

  @property
  def state(self):
    """Adam's per-shard state (at world 1 keyed by the parameters)."""
    return self.optimizer.state

  @property
  def param_groups(self):
    return self.optimizer.param_groups

  def step(self, grads: Sequence[torch.Tensor]) -> None:
    """One Adam step on the (averaged, clipped) whole gradients."""
    for shard, grad, axis in zip(self.shards, grads, self.axes):
      shard.grad = self.data.shard(grad, axis)
    self.optimizer.step()
    self.optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
      for param, shard, axis in zip(self.params, self.shards, self.axes):
        if axis is not None:
          param.copy_(self.data.gather(shard, axis))

  def state_dict(self) -> Optional[dict]:
    state = self.optimizer.state_dict()
    if self.data.world_size == 1:
      return state
    for index, axis in enumerate(self.axes):
      # A copy: state_dict() shares the live per-parameter dicts.
      entry = state['state'][index] = dict(state['state'][index])
      for key in ('exp_avg', 'exp_avg_sq'):
        full = self.data.gather(entry[key], axis)
        entry[key] = full.cpu() if self.data.is_chief else None
    return state if self.data.is_chief else None

  def load_state_dict(self, state_dict: dict) -> None:
    # Copies: Adam keeps a loaded step count (and, on the parameters'
    # device, a whole moment) as the very tensor given, which would tie
    # this optimizer to the source of `state_dict` (another live state).
    state = {'param_groups': state_dict['param_groups'], 'state': {}}
    for index, entry in state_dict['state'].items():
      axis = self.axes[int(index)]
      state['state'][index] = {
          key: (value if key == 'step' else self.data.shard(value, axis)
                ).clone() for key, value in entry.items()}
    self.optimizer.load_state_dict(state)
