"""Config object for SE3DS inference models (a copy of
`se3ds_tpu.models.model_config`, same fields and defaults).

Fields the port does not serve yet raise from `SE3DSModel.__init__`
(see ROADMAP.md): `memory_mode='ring'`, the splat modes 'sorted_packed',
'fast_exact' and 'dual_sorted', and a set `ckpt_path` without
`variables=`.
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
  # Guidance-splat winner selection. The port serves 'fast' (packed
  # depth-bucket | feature-byte winner, exact depth) and 'pallas' (the
  # same semantics; both run the 'fast' CUDA kernel on the card), and the
  # exact modes 'scatter', 'sorted' and 'pallas_exact' (min depth, 0.1 m
  # window, per-channel max; all run the exact CUDA kernel on the card).
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
  # 'strict' raises when memory is full; 'ring' is not ported yet.
  memory_mode: str = 'strict'


def get_config() -> SE3DSConfig:
  """Returns the Val-Unseen config for SE3DS."""
  return SE3DSConfig(ckpt_path=constants.CKPT_UNSEEN, resnet_version='101')


def get_test_config() -> SE3DSConfig:
  """Returns config used for unit tests."""
  return SE3DSConfig(ckpt_path=None, hidden_dims=4, z_dim=4, gen_dims=4,
                     image_height=32, memory_frames=3,
                     resnet_version='tiny',
                     pole_compact=False)
