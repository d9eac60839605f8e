"""Config object for SE3DS inference models (a copy of
`se3ds_tpu.models.model_config`, same fields and defaults).

Every field is served. A `ckpt_path` names a checkpoint the port wrote
(`train.checkpoints.restore_ema_generator`).
"""

import dataclasses
from typing import Optional

from se3ds_torch import constants


@dataclasses.dataclass
class SE3DSConfig:
  """Parameters used to configure SE3DS models."""
  # Independent scenes served in lockstep; each owns its memory slice.
  batch_size: int = 1
  ckpt_path: Optional[str] = constants.CKPT_UNSEEN
  hidden_dims: int = 128
  random_noise: bool = True
  z_dim: int = 32
  circular_pad: bool = True
  depth_scale: float = constants.DEPTH_SCALE
  gen_dims: int = 128
  image_height: int = 512
  h_fov: float = 0.17
  resnet_version: str = '101'
  use_blurred_mask: bool = True
  memory_frames: int = constants.PANO_VIDEO_LENGTH  # capacity in frames
  compute_dtype: str = 'float32'  # 'bfloat16' for faster inference
  # Guidance-splat winner selection (ops/splat.py). Every mode keeps the
  # exact minimum depth per pixel; they differ in the features:
  #   'scatter'    exact reference semantics: among the points within
  #                0.1 m of the minimum, the per-channel maximum (the
  #                exact CUDA kernel on the card).
  #   'sorted'     'scatter' (bit-identical; the exact kernel).
  #   'pallas_exact' 'scatter' (the exact kernel).
  #   'sorted_packed' 'scatter' for byte features (RGB, class ids), from
  #                a sort by (pixel, depth) in PyTorch ops; other values
  #                clip and truncate to bytes.
  #   'dual_sorted' 'sorted_packed' of the semantic and the RGB cloud in
  #                one sort; needs project_semantics and no mesh.
  #   'fast'       DEFAULT: the point in the shallowest depth_scale/256
  #                bucket with the largest feature bytes; differs from
  #                'scatter' only where a pixel's window holds several
  #                points (the 'fast' CUDA kernel on the card).
  #   'pallas'     'fast' (the 'fast' kernel).
  #   'fast_exact' the exact 0.1 m window, then the largest feature bytes
  #                of one point (PyTorch ops); equal to 'scatter' where a
  #                window holds one point.
  # The packed modes ('fast', 'pallas', 'fast_exact', 'sorted_packed')
  # return the exact splat for more than 3 feature channels. With a mesh,
  # 'fast', 'fast_exact' and 'scatter' run sharded ('pallas' as 'fast',
  # 'pallas_exact' as 'scatter'); the others raise.
  splat_mode: str = 'fast'
  # The port always folds spectral norms into the kernels at load (it
  # serves eval only); the flag is kept for config compatibility.
  fold_spectral: bool = True
  # Drop the pole rows blanked by mask_pano from the RGB cloud at write
  # time; requires mask_blurred=True on every add_to_memory call.
  pole_compact: bool = True
  # Compute the semantic guidance splat (it only fills
  # OutputData.proj_semantic; the generator never reads it).
  project_semantics: bool = True
  # JAX buffer donation; the port writes its memory in place instead.
  donate_memory: bool = True
  # Behaviour when a memory write would exceed `memory_frames` capacity:
  #   'strict' (default) raise from the host API before the write — the
  #            documented fixed-capacity contract (the reference instead
  #            grows its memory unboundedly, models.py:239-245).
  #   'ring'   overwrite the OLDEST frame's slots (a sliding window over
  #            the last `memory_frames` observations): unbounded streaming
  #            trajectories at constant device memory. Below capacity the
  #            two modes are bit-identical; after a wrap the memory holds
  #            exactly the most recent `memory_frames` frames.
  memory_mode: str = 'strict'


def get_config() -> SE3DSConfig:
  """Returns the Val-Unseen config for SE3DS."""
  return SE3DSConfig(ckpt_path=constants.CKPT_UNSEEN, resnet_version='101')


def get_re10k_config() -> SE3DSConfig:
  """Returns the RE10K config for SE3DS."""
  return SE3DSConfig(ckpt_path=constants.CKPT_RE10K, resnet_version='101',
                     use_blurred_mask=False,
                     # The RE10K flow writes perspective-derived panos
                     # with mask_blurred=False (no pole blanking), so
                     # the compacted RGB layout does not apply.
                     pole_compact=False)


def get_test_config() -> SE3DSConfig:
  """Returns config used for unit tests."""
  return SE3DSConfig(ckpt_path=None, hidden_dims=4, z_dim=4, gen_dims=4,
                     image_height=32, memory_frames=3,
                     resnet_version='tiny',
                     pole_compact=False)
