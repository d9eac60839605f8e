"""Stateful SE3DS serving API (port of `se3ds_tpu.models.inference`).

The point-cloud memory is a fixed-capacity buffer (capacity =
memory_frames * H * W points) with a write cursor. Every frame writes
exactly H*W semantic slots (fewer RGB slots with pole compaction);
invalid points keep their void feature value, which the splat skips.
Unlike the JAX package, which returns new buffers, the port writes the
memory buffers in place; `get_memory_state()` copies them by default.

Not ported yet (ROADMAP.md): ring memory, `predict_poses`, the device
mesh, `.ply` export, and restoring an Orbax checkpoint (pass
`variables=` instead).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from se3ds_torch import constants
from se3ds_torch import device as device_lib
from se3ds_torch.models import folding
from se3ds_torch.models import generator as generator_lib
from se3ds_torch.models import model_config
from se3ds_torch.ops import geometry


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
                    write_slot: Optional[int] = None) -> MemoryState:
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
    write_slot: FRAME slot to write; defaults to the one after the cursor.

  Returns:
    The memory state with the cursor advanced by H*W (saturating at
    capacity).
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
  cap = memory.coords.shape[-1]
  rgb_cap = memory.rgb_coords.shape[-1]
  if write_slot is None:
    write_slot = memory.cursor // num_new
  cur = write_slot * num_new
  rgb_cur = write_slot * rgb_new
  if cur + num_new > cap or rgb_cur + rgb_new > rgb_cap:
    raise ValueError(f'Frame slot {write_slot} ({num_new}/{rgb_new} points)'
                     f' exceeds memory capacity {cap}/{rgb_cap}.')
  memory.coords[:, :, cur:cur + num_new] = xyz1
  memory.feats[:, cur:cur + num_new] = feats[..., None].to(torch.float32)
  memory.rgb_coords[:, :, rgb_cur:rgb_cur + rgb_new] = rgb_xyz1
  memory.rgb[:, rgb_cur:rgb_cur + rgb_new] = rgb_feats.to(torch.float32)
  return memory._replace(cursor=min(max(memory.cursor, cur + num_new), cap))


def memory_project(memory: MemoryState, position: torch.Tensor, height: int,
                   width: int, depth_scale: float, splat_mode: str = 'fast',
                   project_semantics: bool = True):
  """Splats the memory at a target pose into guidance images.

  Returns (proj_semantic (N,H,W,1) f32, proj_depth (N,H,W), proj_rgb
  (N,H,W,3), proj_mask (N,H,W,1)). With `project_semantics=False` the
  semantic splat is skipped and proj_semantic is all zero.
  """
  relative_position = _transform_position(position.to(torch.float32))
  if project_semantics:
    _, proj_semantic = geometry.project_feats_to_equirectangular(
        memory.feats, memory.coords - relative_position[..., None], height,
        width, constants.INVALID_SEM_VALUE, depth_scale,
        splat_mode=splat_mode)
  else:
    proj_semantic = torch.zeros((memory.coords.shape[0], height, width, 1),
                                dtype=torch.float32,
                                device=memory.coords.device)
  proj_depth, proj_rgb = geometry.project_feats_to_equirectangular(
      memory.rgb, memory.rgb_coords - relative_position[..., None], height,
      width, constants.INVALID_RGB_VALUE, depth_scale, splat_mode=splat_mode)
  proj_mask = (
      (proj_depth > 0) & (proj_depth < 1)
      & torch.all(proj_rgb != constants.INVALID_RGB_VALUE, dim=-1)
  ).to(torch.float32)[..., None]
  return proj_semantic, proj_depth, proj_rgb, proj_mask


class SE3DSModel:
  """Serves SE3DS predictions from a point-cloud memory.

  Runs on the card by default; pass `device='cpu'` to run the plain
  PyTorch versions of the kernels on the CPU.
  """

  _LEAN_KEYS = ('proj_semantic_u8', 'pred_semantic_u8', 'proj_rgb_u8',
                'pred_rgb_u8', 'proj_depth', 'pred_depth', 'mu', 'logvar',
                'proj_mask')

  def __init__(self, config: model_config.SE3DSConfig, variables=None,
               device=None, generator: Optional[torch.Generator] = None):
    """Args:

    config: the model configuration.
    variables: the JAX package's generator variables ({'params',
      'batch_stats'[, 'spectral']}, numpy or JAX arrays); converted by
      `folding.torch_state_dict_from_flax`.
    device: 'cuda' (default; raises without a card) or 'cpu'.
    generator: seeds the random weights when `variables` is None and
      `config.ckpt_path` is None (default: seed 0 on `device`).
    """
    self.device = device_lib.resolve(device, 'SE3DSModel')
    if config.batch_size < 1:
      raise ValueError(f'batch_size must be >= 1, got {config.batch_size}.')
    if config.memory_mode != 'strict':
      raise NotImplementedError(
          f"memory_mode={config.memory_mode!r}: only 'strict' is ported "
          '(ring memory is a later ROADMAP item).')
    if config.splat_mode not in geometry.SPLAT_MODES:
      raise NotImplementedError(
          f'splat_mode={config.splat_mode!r} is not ported yet; use one of '
          f'{geometry.SPLAT_MODES} (ROADMAP.md item A10 lists the rest).')
    if variables is None and config.ckpt_path is not None:
      raise NotImplementedError(
          f'Restoring the Orbax checkpoint {config.ckpt_path!r} needs JAX; '
          'restore it with the JAX package and pass its variables with '
          'variables=, or set ckpt_path=None for random weights.')
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
    else:
      if generator is None:
        generator = torch.Generator(device=self.device).manual_seed(0)
      folding.init_random_(self.model, generator)
      print('Initializing SE3DS model from scratch.')
    # Conv kernels are stored in the compute dtype once (BatchNorm
    # parameters and biases stay float32).
    for param in self.model.parameters():
      if param.dim() == 4:
        param.data = param.data.to(dtype)
    self.model.eval().requires_grad_(False)
    self.prev_rgb_frame = None
    self.reset_memory()

  # -- memory management ----------------------------------------------------

  def reset_memory(self):
    self._memory = init_memory(self.batch_size, self.capacity,
                               self.rgb_capacity, device=self.device)
    self._frames_written = 0
    # True where the slot holds real semantics (written by add_to_memory);
    # predicted frames write all-void semantics and are skipped.
    self._sem_real = [False] * self.config.memory_frames

  def _sem_frames_live(self) -> int:
    """1 + the highest slot holding real semantics (0 when none)."""
    real = [i for i, r in enumerate(self._sem_real) if r]
    return (max(real) + 1) if real else 0

  def _count_frames(self, new_frames: int = 1):
    self._frames_written = min(self.config.memory_frames,
                               self._frames_written + new_frames)

  def get_memory_state(self, copy: bool = True) -> MemoryState:
    """The current memory; `copy=False` returns the live buffers, which
    later mutating calls overwrite in place."""
    if not copy:
      return self._memory
    return self._memory._replace(
        **{k: v.clone() for k, v in self._memory._asdict().items()
           if k != 'cursor'})

  def set_memory_state(self, state: MemoryState):
    if state.rgb_coords.shape[-1] != self.rgb_capacity:
      raise ValueError(
          f'MemoryState RGB capacity {state.rgb_coords.shape[-1]} does not '
          f"match this model's layout ({self.rgb_capacity}; "
          f'pole_compact={self.config.pole_compact}).')
    self._memory = MemoryState(
        coords=self._tensor(state.coords).clone(),
        feats=self._tensor(state.feats).clone(),
        rgb_coords=self._tensor(state.rgb_coords).clone(),
        rgb=self._tensor(state.rgb).clone(),
        cursor=int(state.cursor))
    frame_points = self.height * self.width
    self._frames_written = min(self.config.memory_frames,
                               -(-self._memory.cursor // frame_points))
    # A restored state carries no per-slot provenance: treat every
    # written slot as holding real semantics (exact, only slower).
    self._sem_real = [i < self._frames_written
                      for i in range(self.config.memory_frames)]

  def _check_memory_capacity(self):
    if self._frames_written >= self.config.memory_frames:
      raise ValueError(
          f'Point-cloud memory is full ({self.config.memory_frames} frames'
          f' = {self.capacity} points). Increase'
          ' SE3DSConfig.memory_frames or call reset_memory().')

  def _tensor(self, x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=self.device)

  @torch.no_grad()
  def add_to_memory(self, pano_rgb, pano_semantic, pano_depth, position,
                    mask_blurred: bool = True):
    """Adds an equirectangular observation to memory."""
    self._check_memory_capacity()
    pano_rgb = self._tensor(pano_rgb)
    self.prev_rgb_frame = (pano_rgb / 255).to(torch.float32)
    slot = self._frames_written  # strict memory: the next free frame
    self._memory = memory_add_pano(
        self._memory, pano_rgb, self._tensor(pano_semantic),
        self._tensor(pano_depth, torch.float32),
        self._tensor(position, torch.float32), self.depth_scale,
        mask_blurred=mask_blurred, pole_compact=self.config.pole_compact,
        write_slot=slot)
    self._sem_real[slot] = True
    self._count_frames()

  # -- forward --------------------------------------------------------------

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
        project_semantics=self.config.project_semantics)
    proj_semantic_img = proj_semantic[..., 0]
    proj_rgb_norm = torch.clamp(proj_rgb / 255.0, 0.0, 1.0)
    inputs = {
        'prev_image': prev_rgb_frame,
        'proj_image': proj_rgb_norm,
        'proj_depth': proj_depth[..., None],
        'proj_mask': proj_mask,
        'blurred_mask': torch.zeros_like(proj_mask),
    }
    (mu, logvar, _, pred_depth, pred_semantic, _, generated_rgb
     ) = self.model(inputs)
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
                    write_slot: int, num_frames: int,
                    use_projected_rgb: bool = False,
                    sem_frames: Optional[int] = None):
    """One feedback frame: splat -> generate -> unproject -> memory write.

    Returns (lean output dict, new memory, new prev_rgb_frame).
    """
    out = self._forward(memory, prev_rgb_frame, position,
                        num_frames=num_frames, feed=True,
                        sem_frames=sem_frames)
    # The memory feed is always the generator's raw outputs.
    new_memory = memory_add_pano(
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
      new_prev = (torch.clamp(out['pc_rgb'], 0, 255) / 255).to(torch.float32)
    return lean, new_memory, new_prev

  @torch.no_grad()
  def predict_trajectory(self, positions) -> OutputData:
    """Autoregressively predicts T frames, one `_step_forward` each.

    Equal, bit for bit, to calling `self(position,
    add_preds_to_memory=True)` for each position in turn.

    Args:
      positions: (T, 3) or (T, N, 3) world positions, one per frame.

    Returns:
      OutputData with a leading trajectory axis on every field.
    """
    positions = self._tensor(positions, torch.float32)
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
    if self.prev_rgb_frame is None:
      raise ValueError('add_to_memory must be called before predicting.')
    if self._frames_written + num_frames > self.config.memory_frames:
      raise ValueError(
          f'Trajectory of {num_frames} frames would exceed memory capacity '
          f'({self._frames_written} written, {self.config.memory_frames} '
          'total). Increase SE3DSConfig.memory_frames or reset_memory().')
    start = self._frames_written
    sem_frames = self._sem_frames_live()
    per_frame = []
    for t in range(num_frames):
      lean, self._memory, self.prev_rgb_frame = self._step_forward(
          self._memory, self.prev_rgb_frame, positions[t],
          write_slot=start + t, num_frames=max(1, start + t),
          sem_frames=sem_frames)
      per_frame.append(lean)
      self._sem_real[start + t] = False
      self._count_frames()
    stacked = {k: torch.stack([f[k] for f in per_frame])
               for k in self._LEAN_KEYS}
    return self._to_output_data(stacked)

  @torch.no_grad()
  def __call__(self, position, add_preds_to_memory: bool = False,
               sample_noise: bool = False, use_projected_rgb: bool = False,
               z=None) -> OutputData:
    """Predicts the frame at `position`.

    `sample_noise` and `z` are accepted for signature parity and ignored:
    the release generator consumes no noise.
    """
    del sample_noise, z
    position = self._tensor(position, torch.float32)
    if self.prev_rgb_frame is None:
      raise ValueError('add_to_memory must be called before predicting.')
    num_frames = max(1, self._frames_written)
    sem_frames = self._sem_frames_live()
    if add_preds_to_memory:
      self._check_memory_capacity()
      slot = self._frames_written  # strict memory: the next free frame
      out, self._memory, self.prev_rgb_frame = self._step_forward(
          self._memory, self.prev_rgb_frame, position, slot,
          num_frames=num_frames, use_projected_rgb=use_projected_rgb,
          sem_frames=sem_frames)
      self._sem_real[slot] = False  # predicted semantics are all void
      self._count_frames()
      return self._to_output_data(out)
    out = self._forward(self._memory, self.prev_rgb_frame, position,
                        num_frames=num_frames, sem_frames=sem_frames)
    return self._to_output_data(out)
