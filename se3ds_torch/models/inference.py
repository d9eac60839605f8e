"""Stateful SE3DS serving API (port of `se3ds_tpu.models.inference`).

The point-cloud memory is a fixed-capacity buffer (capacity =
memory_frames * H * W points) with a write cursor. Every frame writes
exactly H*W semantic slots (fewer RGB slots with pole compaction);
invalid points keep their void feature value, which the splat skips.
Unlike the JAX package, which returns new buffers, the port writes the
memory buffers and the previous frame in place, at addresses fixed for
the life of the model; `get_memory_state()` copies them by default.

How it runs. On a CUDA device each entry point is one captured CUDA
graph per key, as each is one compiled program in the JAX package
(`SE3DSModel` lists the keys; `models/graphs.py` captures and replays):
`add_to_memory`, `__call__` with and without `add_preds_to_memory`,
`predict_trajectory` (all T frames in one graph, no host step between
them) and `predict_poses`. The first call of a key runs eagerly, as do
every call on the CPU, a model built with `cuda_graphs=False` and a
model with a `mesh` (its collectives are not captured). The host keeps
the frame counters and the per-slot semantic bookkeeping, between
calls.

Each entry point is one span of `se3ds_torch.tracing` from entry to
return, timed on the card (`serve.add`, `serve.call`, `serve.step`,
`serve.trajectory`, `serve.poses`), with the children of
`graphs.Programs.run` (`upload`, then `eager`, or `capture` and `replay`,
then `copy_out`), and counts itself in `serve.calls`; building the model
is the span `serve.build`.

Everything of the JAX API is here: strict and ring memory, the fused
trajectory, `predict_poses`, `.ply` export, restoring a checkpoint, every
splat mode, and the device mesh (`mesh=`, a `DeviceMesh` of
`parallel.mesh.create_mesh`: the splat's points spread over its 'data'
ranks, the generator's rows over its 'spatial' ranks). `ckpt_path` names
a checkpoint the port wrote (`train.checkpoints.restore_ema_generator`);
the JAX package's Orbax checkpoints are restored there and passed in with
`variables=`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from se3ds_torch import constants
from se3ds_torch import device as device_lib
from se3ds_torch import tracing
from se3ds_torch.models import folding
from se3ds_torch.models import generator as generator_lib
from se3ds_torch.models import graphs
from se3ds_torch.models import layers
from se3ds_torch.models import model_config
from se3ds_torch.models import spatial
from se3ds_torch.ops import geometry
from se3ds_torch.parallel import splat_shard
from se3ds_torch.train import checkpoints


class PanoData(NamedTuple):
  """A Matterport3D panorama.

  position: (3,) float xyz coordinates.
  rgb: (H, W, 3) int32 RGB panorama.
  semantic: (H, W) int32 semantic segmentation panorama.
  depth: (H, W) float32 depth in [0, 1].
  """
  position: torch.Tensor
  rgb: torch.Tensor
  semantic: torch.Tensor
  depth: torch.Tensor


class MemoryState(NamedTuple):
  """Fixed-capacity point-cloud memory.

  coords: (N, 4, CAP) float32 homogeneous coordinates (semantic cloud).
  feats: (N, CAP, 1) float32 semantic features (void == INVALID_SEM_VALUE).
  rgb_coords: (N, 4, RGB_CAP) float32 homogeneous coordinates (RGB cloud).
  rgb: (N, RGB_CAP, 3) float32 RGB features in [0, 255] (void == -1).
  cursor: number of semantic slots written (a Python int).
  """
  coords: torch.Tensor
  feats: torch.Tensor
  rgb_coords: torch.Tensor
  rgb: torch.Tensor
  cursor: int


class OutputData(NamedTuple):
  """Prediction outputs (the reference's fields; the last five are
  navigation-graph vestiges the release never fills)."""
  proj_semantic: torch.Tensor
  pred_semantic: torch.Tensor
  proj_rgb: torch.Tensor
  pred_rgb: torch.Tensor
  proj_depth: torch.Tensor
  pred_depth: torch.Tensor
  mu: torch.Tensor
  logvar: torch.Tensor
  proj_mask: Optional[torch.Tensor] = None
  heading_enc: Optional[Any] = None
  pitch_enc: Optional[Any] = None
  features_enc: Optional[Any] = None
  predicted_bucket_probs: Optional[torch.Tensor] = None
  predicted_node_xyz: Optional[list] = None


def init_memory(batch_size: int, capacity: int,
                rgb_capacity: Optional[int] = None,
                device: Optional[torch.device] = None) -> MemoryState:
  """Creates an empty memory; all slots hold void features."""
  rgb_capacity = capacity if rgb_capacity is None else rgb_capacity
  f32 = dict(dtype=torch.float32, device=device)
  return MemoryState(
      coords=torch.zeros((batch_size, 4, capacity), **f32),
      feats=torch.full((batch_size, capacity, 1),
                       float(constants.INVALID_SEM_VALUE), **f32),
      rgb_coords=torch.zeros((batch_size, 4, rgb_capacity), **f32),
      rgb=torch.full((batch_size, rgb_capacity, 3),
                     float(constants.INVALID_RGB_VALUE), **f32),
      cursor=0)


def pole_valid_rows(height: int, proportion: float = 0.125) -> Tuple[int, int]:
  """Row slice [start, stop) surviving `geometry.mask_pano`."""
  mh = int(height * proportion)
  return mh, height - mh + 1


def _transform_position(xyz: torch.Tensor) -> torch.Tensor:
  """(N, 3) -> (N, 4) with homogeneous 0."""
  return torch.cat([xyz, torch.zeros_like(xyz[:, :1])], dim=1)


def memory_add_pano(memory: MemoryState,
                    pano_rgb: torch.Tensor,
                    pano_semantic: torch.Tensor,
                    pano_depth: torch.Tensor,
                    position: torch.Tensor,
                    depth_scale: float,
                    mask_blurred: bool = True,
                    pole_compact: bool = False,
                    *, write_slot) -> None:
  """Unprojects an RGB-D pano and writes it into the memory, in place.

  Args:
    memory: Current memory state; its buffers are updated in place.
    pano_rgb: (N, H, W, 3) int/float RGB in [0, 255].
    pano_semantic: (N, H, W, 1) semantic class image.
    pano_depth: (N, H, W) float32 depth in [0, 1].
    position: (N, 3) world position.
    depth_scale: Maximum depth in metres.
    mask_blurred: Blank top/bottom 1/8th of the RGB before unprojection.
    pole_compact: Drop the blanked pole rows from the RGB cloud (requires
      mask_blurred=True and a memory laid out with `pole_valid_rows(H)`
      rows per frame).
    write_slot: FRAME slot to write: an int, or a 0-dim int64 tensor on
      the memory's device (what a captured CUDA graph reads). Its bounds
      and the cursor are the caller's (`SE3DSModel` knows the slot on the
      host and advances the cursor).
  """
  if pole_compact and not mask_blurred:
    raise ValueError(
        'pole_compact drops the pole-masked RGB rows, which only exist '
        'with mask_blurred=True. Pass mask_blurred=True or build the '
        'model with SE3DSConfig(pole_compact=False).')
  pano_rgb = pano_rgb.to(torch.int32)
  pano_semantic = pano_semantic.to(torch.int32)
  if mask_blurred:
    pano_rgb = geometry.mask_pano(
        pano_rgb, masked_region_value=constants.INVALID_RGB_VALUE)

  transformed_position = _transform_position(position.to(torch.float32))
  xyz1, feats = geometry.equirectangular_to_pointcloud(
      pano_semantic[..., 0], pano_depth, constants.INVALID_SEM_VALUE,
      depth_scale, interpolation_method='nearest')
  rgb_xyz1, rgb_feats = geometry.equirectangular_to_pointcloud(
      pano_rgb, pano_depth, constants.INVALID_RGB_VALUE, depth_scale,
      interpolation_method='bilinear')
  xyz1 = xyz1 + transformed_position[:, :, None]
  rgb_xyz1 = rgb_xyz1 + transformed_position[:, :, None]

  height, width = pano_depth.shape[1], pano_depth.shape[2]
  if pole_compact:
    r0, r1 = pole_valid_rows(height)
    n = rgb_xyz1.shape[0]
    rgb_xyz1 = rgb_xyz1.reshape(n, 4, height, width)[:, :, r0:r1].reshape(
        n, 4, -1)
    rgb_feats = rgb_feats.reshape(n, height, width, -1)[:, r0:r1].reshape(
        n, -1, rgb_feats.shape[-1])

  num_new = xyz1.shape[-1]
  rgb_new = rgb_xyz1.shape[-1]
  batch = memory.coords.shape[0]
  slot = torch.as_tensor(write_slot, dtype=torch.int64, device=xyz1.device)
  index = slot * num_new + torch.arange(num_new, device=xyz1.device)
  rgb_index = slot * rgb_new + torch.arange(rgb_new, device=xyz1.device)
  memory.coords.index_copy_(2, index, xyz1.expand(batch, -1, -1))
  memory.feats.index_copy_(1, index, feats[..., None].to(
      torch.float32).expand(batch, -1, -1))
  memory.rgb_coords.index_copy_(2, rgb_index, rgb_xyz1.expand(batch, -1, -1))
  memory.rgb.index_copy_(1, rgb_index, rgb_feats.to(torch.float32).expand(
      batch, -1, -1))


def _proj_mask(proj_depth: torch.Tensor, proj_rgb: torch.Tensor
               ) -> torch.Tensor:
  return ((proj_depth > 0) & (proj_depth < 1)
          & torch.all(proj_rgb != constants.INVALID_RGB_VALUE, dim=-1)
          ).to(torch.float32)[..., None]


def memory_project(memory: MemoryState, position: torch.Tensor, height: int,
                   width: int, depth_scale: float, splat_mode: str = 'fast',
                   project_semantics: bool = True, mesh=None,
                   mesh_axis: str = 'data'):
  """Splats the memory at a target pose into guidance images.

  Returns (proj_semantic (N,H,W,1) f32, proj_depth (N,H,W), proj_rgb
  (N,H,W,3), proj_mask (N,H,W,1)). With `project_semantics=False` the
  semantic splat is skipped and proj_semantic is all zero.

  With `mesh` (a `DeviceMesh` of `parallel.mesh.create_mesh`), each rank
  of the `mesh_axis` group splats its share of the point axis of both
  clouds and the buffers combine over the group
  (`parallel.splat_shard`): every rank gets the whole images, equal to
  the unsharded splat. splat_mode='dual_sorted' splats both clouds in
  one sort (`geometry.project_dual_to_equirectangular`); it needs
  project_semantics=True and has no sharded path.
  """
  relative_position = _transform_position(position.to(torch.float32))
  if splat_mode == 'dual_sorted':
    if mesh is not None or not project_semantics:
      raise ValueError(
          "splat_mode='dual_sorted' fuses the semantic+RGB pair, so it "
          'needs project_semantics=True and has no sharded path.')
    offset = relative_position[..., None]
    proj_depth, proj_semantic, proj_rgb = (
        geometry.project_dual_to_equirectangular(
            memory.feats, memory.coords - offset, memory.rgb,
            memory.rgb_coords - offset, height, width,
            sem_void_class=constants.INVALID_SEM_VALUE,
            rgb_void_class=constants.INVALID_RGB_VALUE,
            depth_scale=depth_scale))
    return proj_semantic, proj_depth, proj_rgb, _proj_mask(proj_depth,
                                                           proj_rgb)
  if mesh is not None:
    project = functools.partial(
        splat_shard.project_memory_equirect_sharded,
        group=mesh.get_group(mesh_axis), splat_mode=splat_mode)
  else:
    project = functools.partial(geometry.project_memory_equirect,
                                splat_mode=splat_mode)
  if project_semantics:
    # Nobody reads the semantic depth: the 'fast' kernel skips it.
    _, proj_semantic = project(
        memory.feats, memory.coords, relative_position, height, width,
        constants.INVALID_SEM_VALUE, depth_scale, need_depth=False)
  else:
    proj_semantic = torch.zeros((memory.coords.shape[0], height, width, 1),
                                dtype=torch.float32,
                                device=memory.coords.device)
  proj_depth, proj_rgb = project(
      memory.rgb, memory.rgb_coords, relative_position, height, width,
      constants.INVALID_RGB_VALUE, depth_scale)
  return proj_semantic, proj_depth, proj_rgb, _proj_mask(proj_depth, proj_rgb)


class SE3DSModel:
  """Serves SE3DS predictions from a point-cloud memory.

  Runs on the card by default; pass `device='cpu'` to run the plain
  PyTorch versions of the kernels on the CPU.

  On a CUDA device every entry point (`add_to_memory`, `__call__` with
  and without `add_preds_to_memory`, `predict_trajectory`,
  `predict_poses`) replays a captured CUDA graph, one per key, as the JAX
  package runs one compiled program per static-argument variant
  (`models/graphs.py`; the first call of a key runs eagerly and warms
  up, the second captures). The keys:

  - `add_to_memory`: `mask_blurred`;
  - `__call__`: the frame bucket and the semantic bucket (the live
    extents rounded up to powers of two, capped at `memory_frames`: the
    extra slots are void and the splat skips them);
  - `__call__(add_preds_to_memory=True)`: the same and
    `use_projected_rgb`; the write slot is a device scalar, so it adds
    no graphs;
  - `predict_trajectory`: T, the frames written before it and the exact
    semantic extent; all T frames are one graph, the start slot a device
    scalar;
  - `predict_poses`: K, the frame bucket and the semantic bucket;

  and each also by its inputs' shapes and dtypes and the config's
  `splat_mode` and `project_semantics`. With L frame buckets (1, 2, 4,
  ... and `memory_frames`: ceil(log2(memory_frames)) + 1), a model holds
  at most L(L+1)/2 read-only `__call__` graphs (the semantic bucket never
  exceeds the frame bucket) and L(L+1) step graphs per input signature,
  in strict and in ring mode; after a ring wrap the frame bucket stays
  `memory_frames`, so new keys add at most L read-only and 2L step
  graphs. In the usual flow (one `add_to_memory`, then predictions) the
  semantic bucket stays 1: L read-only and 2L step graphs at most.
  """

  _LEAN_KEYS = ('proj_semantic_u8', 'pred_semantic_u8', 'proj_rgb_u8',
                'pred_rgb_u8', 'proj_depth', 'pred_depth', 'mu', 'logvar',
                'proj_mask')

  def __init__(self, config: model_config.SE3DSConfig, variables=None,
               device=None, generator: Optional[torch.Generator] = None,
               mesh=None, mesh_axis: str = 'data',
               cuda_graphs: bool = True):
    """Args:

    config: the model configuration.
    variables: the JAX package's generator variables ({'params',
      'batch_stats'[, 'spectral']}, numpy or JAX arrays); converted by
      `folding.torch_state_dict_from_flax`.
    device: 'cuda' (default; raises without a card) or 'cpu'.
    generator: seeds the random weights when `variables` is None and
      `config.ckpt_path` is None (default: seed 0 on `device`).

    With `variables` None and `config.ckpt_path` set, the weights come
    from that checkpoint (`checkpoints.restore_ema_generator`: a file of
    `save_ema_generator`, or the EMA generator of a `CheckpointManager`
    directory). A missing path raises FileNotFoundError and an Orbax
    directory of the JAX package raises ValueError; neither falls back to
    random weights.

    mesh/mesh_axis: a `DeviceMesh` with dims ('data', 'spatial')
    (`parallel.mesh.create_mesh`) over the ranks that all build this model
    and make the same calls. The memory splats spread their points over
    the `mesh_axis` ranks (`parallel.splat_shard`: 'fast', 'fast_exact'
    and 'scatter'; 'pallas' becomes 'fast' and 'pallas_exact' 'scatter',
    as in the JAX package, and any other mode raises ValueError); with a
    'spatial' size above 1 the generator's rows spread over the 'spatial'
    ranks (`models.spatial`). Every rank returns the same whole outputs.

    cuda_graphs: whether calls replay captured CUDA graphs (see the
      class doc). True captures where the model can: on a CUDA device and
      without a `mesh` (its collectives are a later slice); the CPU and a
      mesh run eagerly. False runs eagerly on the card too, which is what
      it is for: running the eager and the captured model side by side.
      `uncaptured` says why a model runs eagerly.
    """
    with tracing.span('serve.build'):
      self._build(config, variables, device, generator, mesh, mesh_axis,
                  cuda_graphs)

  def _build(self, config, variables, device, generator, mesh, mesh_axis,
             cuda_graphs):
    self.device = device_lib.resolve(device, 'SE3DSModel')
    if config.batch_size < 1:
      raise ValueError(f'batch_size must be >= 1, got {config.batch_size}.')
    if config.memory_mode not in ('strict', 'ring'):
      raise ValueError(f"memory_mode must be 'strict' or 'ring', got "
                       f'{config.memory_mode!r}.')
    if config.splat_mode not in geometry.SPLAT_MODES:
      raise ValueError(f'unknown splat_mode {config.splat_mode!r}; use one '
                       f'of {geometry.SPLAT_MODES}.')
    self.mesh, self.mesh_axis, self._rows = mesh, mesh_axis, None
    if mesh is not None:
      # Each kernel mode's sharded twin is the mode of its semantics.
      renamed = {'pallas': 'fast', 'pallas_exact': 'scatter'}
      config = dataclasses.replace(config, splat_mode=renamed.get(
          config.splat_mode, config.splat_mode))
      if config.splat_mode not in splat_shard.SHARDED_MODES:
        raise ValueError(
            f'splat_mode={config.splat_mode!r} has no sharded path; use '
            "'fast', 'fast_exact', or 'scatter' with a mesh.")
      if mesh.device_type != self.device.type:
        raise ValueError(f'a {mesh.device_type} mesh for a model on '
                         f'{self.device}')
      sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
      if sizes.get('spatial', 1) > 1:
        self._rows = spatial.Rows(mesh.get_group('spatial'))
    # Why calls run eagerly (None when they replay captured graphs).
    if self.device.type != 'cuda':
      self.uncaptured = 'the CPU runs eagerly'
    elif mesh is not None:
      self.uncaptured = ('a mesh: its collectives are not captured (a later '
                         'slice)')
    elif not cuda_graphs:
      self.uncaptured = 'cuda_graphs=False'
    else:
      self.uncaptured = None
    # The captured programs (`graphs.Programs`); None runs eagerly.
    self.graphs = graphs.Programs() if self.uncaptured is None else None
    # Ring mode: writes past capacity wrap onto the oldest frame's slots
    # instead of raising (SE3DSConfig.memory_mode).
    self._ring = config.memory_mode == 'ring'
    self.config = config
    self.batch_size = config.batch_size
    self.height = config.image_height
    self.width = config.image_height * 2
    self.depth_scale = config.depth_scale
    self.capacity = config.memory_frames * self.height * self.width
    if config.pole_compact:
      r0, r1 = pole_valid_rows(self.height)
      self._rgb_frame_points = (r1 - r0) * self.width
    else:
      self._rgb_frame_points = self.height * self.width
    self.rgb_capacity = config.memory_frames * self._rgb_frame_points
    dtype = (torch.bfloat16 if config.compute_dtype == 'bfloat16'
             else torch.float32)

    with torch.device(self.device):
      self.model = generator_lib.ResNetGenerator(
          resnet_version=config.resnet_version, gen_dims=config.gen_dims,
          use_blurred_mask=config.use_blurred_mask, dtype=dtype)
    if variables is not None:
      self.model.load_state_dict(
          folding.torch_state_dict_from_flax(variables, self.model))
    elif config.ckpt_path is not None:
      self.model.load_state_dict(checkpoints.restore_ema_generator(
          config.ckpt_path, target=self.model, device=self.device))
      print('Restored from', config.ckpt_path)
    else:
      if generator is None:
        generator = torch.Generator(device=self.device).manual_seed(0)
      folding.init_random_(self.model, generator)
      print('Initializing SE3DS model from scratch.')
    layers.store_served_kernels(self.model, dtype)
    self.model.eval().requires_grad_(False)
    # The state every call reads lives at fixed addresses for the life of
    # the model (a captured graph replays them): the memory buffers and
    # the previous frame are written in place, never rebound.
    self._memory = init_memory(self.batch_size, self.capacity,
                               self.rgb_capacity, device=self.device)
    self.prev_rgb_frame = torch.zeros(
        (self.batch_size, self.height, self.width, 3), dtype=torch.float32,
        device=self.device)
    self._has_prev_frame = False
    self.reset_memory()

  # -- memory management ----------------------------------------------------

  def reset_memory(self):
    """Empties the memory, in place."""
    memory = self._memory
    memory.coords.zero_()
    memory.feats.fill_(float(constants.INVALID_SEM_VALUE))
    memory.rgb_coords.zero_()
    memory.rgb.fill_(float(constants.INVALID_RGB_VALUE))
    self._memory = memory._replace(cursor=0)
    # _frames_written = VALID frames (the live splat extent, <=
    # memory_frames); _total_frames = frames ever written (drives the ring
    # write slot). Equal until the first ring wrap.
    self._frames_written = 0
    self._total_frames = 0
    # True where the slot holds real semantics (written by add_to_memory);
    # predicted frames write all-void semantics and are skipped.
    self._sem_real = [False] * self.config.memory_frames

  def _next_write_slot(self) -> int:
    """Frame slot the next write lands in (wraps in ring mode)."""
    return self._total_frames % self.config.memory_frames

  def _sem_frames_live(self) -> int:
    """1 + the highest slot holding real semantics (0 when none)."""
    real = [i for i, r in enumerate(self._sem_real) if r]
    return (max(real) + 1) if real else 0

  def _count_frames(self, new_frames: int = 1):
    self._total_frames += new_frames
    self._frames_written = min(self.config.memory_frames,
                               self._frames_written + new_frames)

  def _wrote(self, slot: int, real_semantics: bool):
    """The host's bookkeeping of one frame written at `slot`."""
    frame_points = self.height * self.width
    self._memory = self._memory._replace(cursor=min(
        max(self._memory.cursor, (slot + 1) * frame_points), self.capacity))
    self._sem_real[slot] = real_semantics
    self._count_frames()

  def get_memory_state(self, copy: bool = True) -> MemoryState:
    """The current memory; `copy=False` returns the live buffers, which
    later mutating calls overwrite in place."""
    if not copy:
      return self._memory
    return self._memory._replace(
        **{k: v.clone() for k, v in self._memory._asdict().items()
           if k != 'cursor'})

  def set_memory_state(self, state: MemoryState):
    """Copies `state` into the memory buffers (same layout: batch size,
    capacity and pole_compact)."""
    if state.rgb_coords.shape[-1] != self.rgb_capacity:
      raise ValueError(
          f'MemoryState RGB capacity {state.rgb_coords.shape[-1]} does not '
          f"match this model's layout ({self.rgb_capacity}; "
          f'pole_compact={self.config.pole_compact}).')
    fields = ('coords', 'feats', 'rgb_coords', 'rgb')
    for name in fields:
      got = tuple(getattr(state, name).shape)
      want = tuple(getattr(self._memory, name).shape)
      if got != want:
        raise ValueError(f'MemoryState.{name} has shape {got}; this model '
                         f'holds {want}.')
    for name in fields:
      getattr(self._memory, name).copy_(self._tensor(getattr(state, name)))
    self._memory = self._memory._replace(cursor=int(state.cursor))
    # The cursor counts VALID slots, so a ring-wrapped state restores as
    # full, and later ring writes start over at slot 0 (slot 0 is the
    # oldest frame by convention after a restore).
    frame_points = self.height * self.width
    self._frames_written = min(self.config.memory_frames,
                               -(-self._memory.cursor // frame_points))
    self._total_frames = self._frames_written
    # A restored state carries no per-slot provenance: treat every
    # written slot as holding real semantics (exact, only slower).
    self._sem_real = [i < self._frames_written
                      for i in range(self.config.memory_frames)]

  def write_memory_as_pointcloud(self, filename: str):
    """Writes the valid RGB memory points of batch 0 to an ASCII .ply
    file, byte for byte as the JAX package writes it (numpy float32
    scalars formatted by `str.format`)."""
    mem = self._memory
    xyz = mem.rgb_coords[0, 0:3].T.cpu().numpy()  # (RGB_CAP, 3)
    rgb = mem.rgb[0].cpu().numpy()  # (RGB_CAP, 3)
    cursor = self._frames_written * self._rgb_frame_points
    valid = np.all(rgb[:cursor] != constants.INVALID_RGB_VALUE, axis=-1)
    xyz, rgb = xyz[:cursor][valid], rgb[:cursor][valid]
    with open(filename, 'w') as fp:
      fp.write('ply\n')
      fp.write('format ascii 1.0 \n')
      fp.write('element vertex %d\n' % xyz.shape[0])
      for axis in 'xyz':
        fp.write(f'property float {axis}\n')
      for channel in ('red', 'green', 'blue'):
        fp.write(f'property uchar {channel}\n')
      fp.write('end_header\n')
      colours = rgb.astype(np.int64)
      for point, colour in zip(xyz, colours):
        fp.write('{} {} {} {} {} {} \n'.format(
            point[0], point[1], point[2], colour[0], colour[1], colour[2]))

  def _check_memory_capacity(self):
    """Raises when another frame would not fit (strict mode); ring mode
    never raises: writes wrap onto the oldest frame."""
    if self._ring:
      return
    if self._frames_written >= self.config.memory_frames:
      raise ValueError(
          f'Point-cloud memory is full ({self.config.memory_frames} frames'
          f' = {self.capacity} points). Increase'
          ' SE3DSConfig.memory_frames or call reset_memory().')

  def _check_has_prev_frame(self):
    if not self._has_prev_frame:
      raise ValueError('add_to_memory must be called before predicting.')

  def _tensor(self, x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=self.device)

  def _slot(self, slot: int) -> torch.Tensor:
    """A frame slot as the 0-dim device tensor the programs read."""
    if not 0 <= slot < self.config.memory_frames:
      raise ValueError(f'Frame slot {slot} is outside the memory '
                       f'({self.config.memory_frames} frames).')
    return torch.full((), slot, dtype=torch.int64, device=self.device)

  def _entry(self, name: str) -> tracing.span:
    """The span of one call of an entry point."""
    tracing.counter('serve.calls')
    return tracing.span(name, timed=self.device.type == 'cuda')

  def _run(self, name: Tuple, fn, inputs) -> Dict[str, torch.Tensor]:
    """`fn(*inputs())`: eagerly, or as the captured program of `name`;
    `inputs` uploads the call's input tensors."""
    if self.graphs is None:
      with tracing.span('upload'):
        inputs = inputs()
      return fn(*inputs)
    name = name + (self.config.splat_mode, self.config.project_semantics)
    return self.graphs.run(name, fn, inputs)

  @torch.no_grad()
  def add_to_memory(self, pano_rgb, pano_semantic, pano_depth, position,
                    mask_blurred: bool = True):
    """Adds an equirectangular observation to memory."""
    with self._entry('serve.add'):
      self._check_memory_capacity()
      slot = self._next_write_slot()
      self._run(('add', mask_blurred),
                functools.partial(self._add_program,
                                  mask_blurred=mask_blurred),
                lambda: (self._tensor(pano_rgb), self._tensor(pano_semantic),
                         self._tensor(pano_depth, torch.float32),
                         self._tensor(position, torch.float32),
                         self._slot(slot)))
      self._has_prev_frame = True
      self._wrote(slot, real_semantics=True)

  def _add_program(self, pano_rgb, pano_semantic, pano_depth, position, slot,
                   *, mask_blurred: bool):
    self.prev_rgb_frame.copy_(
        (pano_rgb / device_lib.divisor(255.0, pano_rgb)).to(torch.float32))
    memory_add_pano(
        self._memory, pano_rgb, pano_semantic, pano_depth, position,
        self.depth_scale, mask_blurred=mask_blurred,
        pole_compact=self.config.pole_compact, write_slot=slot)
    return {}

  # -- forward --------------------------------------------------------------

  @staticmethod
  def _pow2_bucket(n: int) -> int:
    """Next power of two >= n: bounds the programs at log2 instead of
    linear (the JAX package's bucket)."""
    return 1 << max(0, n - 1).bit_length()

  def _frame_bucket(self) -> int:
    """The frame extent the read and step programs splat: any extent >=
    the frames written is exact (the extra slots are void and the splat
    skips them)."""
    return min(self._pow2_bucket(max(1, self._frames_written)),
               self.config.memory_frames)

  def _sem_bucket(self) -> int:
    """The semantic extent, bucketed as `_frame_bucket`: any extent >=
    the real-semantics extent is exact."""
    return min(self._pow2_bucket(max(1, self._sem_frames_live())),
               self.config.memory_frames)

  @staticmethod
  def _to_output_data(out: Dict[str, torch.Tensor]) -> OutputData:
    return OutputData(
        proj_semantic=out['proj_semantic_u8'],
        pred_semantic=out['pred_semantic_u8'],
        proj_rgb=out['proj_rgb_u8'],
        pred_rgb=out['pred_rgb_u8'],
        proj_depth=out['proj_depth'],
        pred_depth=out['pred_depth'],
        mu=out['mu'],
        logvar=out['logvar'],
        proj_mask=out['proj_mask'])

  def _live_memory(self, memory: MemoryState, num_frames: int,
                   sem_frames: Optional[int] = None) -> MemoryState:
    """Views of the written extent (exact: the tail is void slots the
    splat skips anyway). `sem_frames` bounds the semantic cloud to the
    frames holding real semantics."""
    extent_frames = max(1, min(num_frames, self.config.memory_frames))
    sem_extent_frames = (extent_frames if sem_frames is None
                         else max(1, min(sem_frames, extent_frames)))
    sem_extent = sem_extent_frames * self.height * self.width
    rgb_extent = extent_frames * self._rgb_frame_points
    return MemoryState(
        coords=memory.coords[:, :, :sem_extent],
        feats=memory.feats[:, :sem_extent],
        rgb_coords=memory.rgb_coords[:, :, :rgb_extent],
        rgb=memory.rgb[:, :rgb_extent],
        cursor=memory.cursor)

  def _forward(self, memory: MemoryState, prev_rgb_frame, position,
               num_frames: int, feed: bool = False,
               sem_frames: Optional[int] = None) -> Dict[str, torch.Tensor]:
    live = self._live_memory(memory, num_frames, sem_frames)
    proj_semantic, proj_depth, proj_rgb, proj_mask = memory_project(
        live, position, self.height, self.width, self.depth_scale,
        splat_mode=self.config.splat_mode,
        project_semantics=self.config.project_semantics, mesh=self.mesh,
        mesh_axis=self.mesh_axis)
    proj_semantic_img = proj_semantic[..., 0]
    proj_rgb_norm = torch.clamp(
        proj_rgb / device_lib.divisor(255.0, proj_rgb), 0.0, 1.0)
    inputs = {
        'prev_image': prev_rgb_frame,
        'proj_image': proj_rgb_norm,
        'proj_depth': proj_depth[..., None],
        'proj_mask': proj_mask,
        'blurred_mask': torch.zeros_like(proj_mask),
    }
    outputs = self.model(inputs, rows=self._rows)
    (mu, logvar, _, pred_depth, pred_semantic, _, generated_rgb
     ) = outputs
    pred_depth = torch.clamp(pred_depth[..., 0], 0.0, 1.0)
    pred_rgb = (torch.clamp(generated_rgb, 0, 1) * 255).to(torch.int32)
    # seg_out is all zero by the release contract; its argmax is class 0.
    pred_semantic = torch.zeros(pred_semantic.shape[:-1], dtype=torch.int32,
                                device=pred_depth.device)
    out = dict(
        proj_depth=proj_depth,
        proj_mask=proj_mask,
        mu=mu, logvar=logvar,
        pred_depth=pred_depth,
        proj_semantic_u8=proj_semantic_img.to(torch.uint8),
        pred_semantic_u8=pred_semantic.to(torch.uint8),
        proj_rgb_u8=(proj_rgb_norm * 255).to(torch.uint8),
        pred_rgb_u8=torch.clamp(pred_rgb, 0, 255).to(torch.uint8),
    )
    if feed:
      out.update(
          proj_semantic=proj_semantic_img.to(torch.int32),
          proj_rgb=proj_rgb_norm,
          pred_semantic=pred_semantic,
          pred_rgb=pred_rgb,
          pc_rgb=torch.clamp((generated_rgb * 255).to(torch.int32),
                             constants.INVALID_RGB_VALUE, 255),
          generated_rgb=generated_rgb,
      )
    return out

  def _step_forward(self, memory: MemoryState, prev_rgb_frame, position,
                    write_slot, num_frames: int,
                    use_projected_rgb: bool = False,
                    sem_frames: Optional[int] = None):
    """One feedback frame: splat -> generate -> unproject -> memory write
    (in place, at the frame slot `write_slot`).

    Returns (lean output dict, new prev_rgb_frame).
    """
    out = self._forward(memory, prev_rgb_frame, position,
                        num_frames=num_frames, feed=True,
                        sem_frames=sem_frames)
    # The memory feed is always the generator's raw outputs.
    memory_add_pano(
        memory, out['pc_rgb'], out['pred_semantic'][..., None],
        out['pred_depth'], position, depth_scale=self.depth_scale,
        mask_blurred=True, pole_compact=self.config.pole_compact,
        write_slot=write_slot)
    new_prev = out['generated_rgb']
    lean = {k: out[k] for k in self._LEAN_KEYS}
    if use_projected_rgb:
      pred_rgb = (out['proj_rgb'] * 255).to(torch.int32) + out['pc_rgb']
      lean['pred_rgb_u8'] = torch.clamp(pred_rgb, 0, 255).to(torch.uint8)
      lean['pred_semantic_u8'] = (
          out['proj_semantic'] + out['pred_semantic']).to(torch.uint8)
      lean['pred_depth'] = out['proj_depth'] + out['pred_depth']
      pc_rgb = torch.clamp(out['pc_rgb'], 0, 255)
      new_prev = (pc_rgb / device_lib.divisor(255.0, pc_rgb)).to(
          torch.float32)
    return lean, new_prev

  def _step_program(self, position, slot, *, num_frames: int,
                    sem_frames: int, use_projected_rgb: bool = False):
    """A feedback frame on the model's own state."""
    lean, new_prev = self._step_forward(
        self._memory, self.prev_rgb_frame, position, slot,
        num_frames=num_frames, use_projected_rgb=use_projected_rgb,
        sem_frames=sem_frames)
    self.prev_rgb_frame.copy_(new_prev)
    return lean

  def _trajectory_program(self, positions, start_slot, *, start_frames: int,
                          sem_frames: int):
    """T feedback frames in one program: frame t's memory write and
    previous frame are on the device when frame t+1 reads them."""
    cap = self.config.memory_frames
    per_frame = [
        self._step_program(positions[t], (start_slot + t) % cap,
                           num_frames=max(1, min(start_frames + t, cap)),
                           sem_frames=sem_frames)
        for t in range(positions.shape[0])]
    return {k: torch.stack([f[k] for f in per_frame])
            for k in self._LEAN_KEYS}

  @torch.no_grad()
  def predict_trajectory(self, positions) -> OutputData:
    """Autoregressively predicts T frames in one program.

    Equal, bit for bit, to calling `self(position,
    add_preds_to_memory=True)` for each position in turn. On the card all
    T frames (splat -> generate -> unproject -> memory write each) are
    one captured graph: no host step between frames, and the memory
    feedback never leaves the device. The frame counters and the
    semantic bookkeeping advance on the host after it.

    Args:
      positions: (T, 3) or (T, N, 3) world positions, one per frame.

    Returns:
      OutputData with a leading trajectory axis on every field.
    """
    with self._entry('serve.trajectory'):
      # Checked where they lie; the upload is the program's.
      positions = torch.as_tensor(positions, dtype=torch.float32)
      if positions.dim() == 2:
        positions = positions[:, None, :]
      if (positions.dim() != 3 or positions.shape[-1] != 3
          or positions.shape[1] not in (1, self.batch_size)):
        raise ValueError(
            f'positions must be (T, 3) or (T, N, 3) with N in '
            f'{{1, {self.batch_size}}}, got {tuple(positions.shape)}.')
      num_frames = positions.shape[0]
      if num_frames < 1:
        raise ValueError('positions must contain at least one frame.')
      self._check_has_prev_frame()
      cap = self.config.memory_frames
      if not self._ring and self._frames_written + num_frames > cap:
        raise ValueError(
            f'Trajectory of {num_frames} frames would exceed memory '
            f'capacity ({self._frames_written} written, {cap} total). '
            'Increase SE3DSConfig.memory_frames, reset_memory(), or use '
            "memory_mode='ring' for unbounded streaming.")
      start_slot = self._next_write_slot()
      start_frames = self._frames_written
      # The exact semantic extent from before the trajectory: predicted
      # frames only ever turn slots void, so it bounds every frame inside
      # it, even across a ring wrap onto real slots.
      sem_frames = min(max(1, self._sem_frames_live()), cap)
      out = self._run(
          ('trajectory', start_frames, sem_frames),
          functools.partial(self._trajectory_program,
                            start_frames=start_frames, sem_frames=sem_frames),
          lambda: (self._tensor(positions), self._slot(start_slot)))
      for t in range(num_frames):
        self._wrote((start_slot + t) % cap, real_semantics=False)
      return self._to_output_data(out)

  def _poses_program(self, positions, *, num_frames: int, sem_frames: int):
    k = positions.shape[0]
    bcast = lambda x: x.expand((k,) + x.shape[1:])
    memory = self._memory._replace(
        coords=bcast(self._memory.coords), feats=bcast(self._memory.feats),
        rgb_coords=bcast(self._memory.rgb_coords),
        rgb=bcast(self._memory.rgb))
    return self._forward(memory, bcast(self.prev_rgb_frame), positions,
                         num_frames=num_frames, sem_frames=sem_frames)

  @torch.no_grad()
  def predict_poses(self, positions) -> OutputData:
    """Predicts K poses from the current scene memory in one batch-K
    forward: K splats of the shared cloud and one batch-K generator pass.
    The memory is not modified. Requires batch_size == 1 (one scene, many
    poses; `SE3DSConfig.batch_size` serves many scenes).

    The memory and the previous frame reach the splat and the generator
    as stride-0 batch-K views (`Tensor.expand`): no K-fold copy is made;
    both splat kernels read points at any batch stride.

    Args:
      positions: (K, 3) world positions.

    Returns:
      OutputData batched over poses: pred_rgb is (K, H, 2H, 3) uint8.
    """
    with self._entry('serve.poses'):
      if self.batch_size != 1:
        raise ValueError('predict_poses serves many poses of ONE scene; '
                         f'model batch_size is {self.batch_size}.')
      # Checked where they lie; the upload is the program's.
      positions = torch.as_tensor(positions, dtype=torch.float32)
      if positions.dim() != 2 or positions.shape[-1] != 3:
        raise ValueError(
            f'positions must be (K, 3), got {tuple(positions.shape)}.')
      if positions.shape[0] < 1:
        raise ValueError('positions must contain at least one pose.')
      self._check_has_prev_frame()
      num_frames, sem_frames = self._frame_bucket(), self._sem_bucket()
      out = self._run(
          ('poses', num_frames, sem_frames),
          functools.partial(self._poses_program, num_frames=num_frames,
                            sem_frames=sem_frames),
          lambda: (self._tensor(positions),))
      return self._to_output_data(out)

  def _call_program(self, position, *, num_frames: int, sem_frames: int):
    return self._forward(self._memory, self.prev_rgb_frame, position,
                         num_frames=num_frames, sem_frames=sem_frames)

  @torch.no_grad()
  def __call__(self, position, add_preds_to_memory: bool = False,
               sample_noise: bool = False, use_projected_rgb: bool = False,
               z=None) -> OutputData:
    """Predicts the frame at `position`.

    `sample_noise` and `z` are accepted for signature parity and ignored:
    the release generator consumes no noise.
    """
    del sample_noise, z
    with self._entry('serve.step' if add_preds_to_memory else 'serve.call'):
      self._check_has_prev_frame()
      num_frames, sem_frames = self._frame_bucket(), self._sem_bucket()
      upload = lambda: (self._tensor(position, torch.float32),)
      if add_preds_to_memory:
        self._check_memory_capacity()
        slot = self._next_write_slot()
        out = self._run(
            ('step', num_frames, sem_frames, use_projected_rgb),
            functools.partial(self._step_program, num_frames=num_frames,
                              sem_frames=sem_frames,
                              use_projected_rgb=use_projected_rgb),
            lambda: upload() + (self._slot(slot),))
        self._wrote(slot, real_semantics=False)  # predicted: all void
        return self._to_output_data(out)
      out = self._run(
          ('call', num_frames, sem_frames),
          functools.partial(self._call_program, num_frames=num_frames,
                            sem_frames=sem_frames), upload)
      return self._to_output_data(out)
