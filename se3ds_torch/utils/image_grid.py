"""Image grids for TensorBoard logging (a copy of
`se3ds_tpu.utils.image_grid`; numpy only)."""

from __future__ import annotations

import math
from typing import Dict, List, Union

import numpy as np


def images_to_grid(images: np.ndarray) -> np.ndarray:
  """(ny, nx, h, w, c) -> (1, ny*h, nx*w, c)."""
  ny, nx, h, w, c = images.shape
  images = np.transpose(images, [0, 2, 1, 3, 4])
  return images.reshape(1, ny * h, nx * w, c)


def get_grid_image(x, show_num: int) -> np.ndarray:
  x = np.asarray(x)
  show_num = min(show_num, x.shape[0])
  x = (np.clip(x[:show_num], 0, 1) * 255.0).astype(np.uint8)
  h_num = int(math.sqrt(show_num))
  w_num = int(show_num / h_num)
  grid_num = h_num * w_num
  _, height, width, channel = x.shape
  x = x[:grid_num].reshape(h_num, w_num, height, width, channel)
  return images_to_grid(x)


def get_grid_image_dict(images: Union[np.ndarray, List, Dict],
                        show_num: int,
                        name_prefix: str) -> Dict[str, np.ndarray]:
  out = {}
  if isinstance(images, list):
    for i, img in enumerate(images):
      out[f'{name_prefix}_{i}'] = get_grid_image(img, show_num)
  elif isinstance(images, dict):
    for key, value in images.items():
      out[f'{name_prefix}_{key}'] = get_grid_image(value, show_num)
  else:
    out[name_prefix] = get_grid_image(images, show_num)
  return out
