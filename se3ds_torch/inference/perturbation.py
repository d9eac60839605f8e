"""Viewpoint-perturbation collision check for VLN augmentation (port of
`se3ds_tpu.inference.perturbation`; reference
inference/perturbation_utils.py)."""

from __future__ import annotations

import math

import numpy as np

from se3ds_torch import constants


def get_proportion_invalid_for_depth(position_offset,
                                     depth_image,
                                     distance_padding: float = 0.10) -> float:
  """Proportion of collided pixels when moving in a given direction.

  Inspects a 30-degree x 60-degree window of the depth pano centred on the
  motion direction and returns the fraction of pixels closer than the
  travel distance + padding.

  Args:
    position_offset: (3,) relative xyz to move toward.
    depth_image: (H, W) depth pano in [0, 1].
    distance_padding: metres of clearance required.

  Returns:
    Scalar proportion in [0, 1].
  """
  position_offset = np.asarray(position_offset, np.float32)
  depth_image = np.asarray(depth_image, np.float32)
  distance = float(np.sqrt(np.sum(position_offset**2)))
  height, width = depth_image.shape

  heading = math.atan2(-position_offset[0], -position_offset[1])
  if heading <= 0:
    heading += 2 * math.pi
  if heading < 0:
    heading += 2 * math.pi
  heading_proportion = heading / (2 * math.pi)

  delta_xy = math.sqrt(position_offset[1]**2 + position_offset[0]**2)
  elevation = math.atan2(delta_xy, -position_offset[2])
  if elevation <= 0:
    elevation += math.pi
  if elevation < 0:
    elevation += math.pi
  elevation_proportion = elevation / math.pi

  heading_start = int(heading_proportion * width)
  elevation_start = int(elevation_proportion * height)

  threshold_width = int(30 / 360 * width)
  threshold_height = int(60 / 180 * height)
  region = depth_image[
      max(0, elevation_start - threshold_height):
      min(height, elevation_start + threshold_height),
      max(0, heading_start - threshold_width):
      min(width, heading_start + threshold_width)]
  return float(np.mean(
      region * constants.DEPTH_SCALE < distance + distance_padding))


def sample_perturbed_views(model, start_position, depth_image, num_samples,
                           rng: np.random.RandomState,
                           max_offset_xy: float = 1.5,
                           max_offset_z: float = 0.1,
                           collision_threshold: float = 0.02,
                           max_attempts: int = 100,
                           chunk: int = 8):
  """VLN augmentation loop (reference VLN notebook cell 13): samples
  collision-free viewpoint jitters and synthesises views there.

  Args:
    model: SE3DSModel with memory already populated.
    start_position: (1, 3) starting xyz.
    depth_image: (H, W) source depth pano in [0, 1].
    num_samples: Number of augmented views to return.
    rng: numpy RandomState; the candidates are drawn in the reference's
      order.
    chunk: Poses synthesised per `model.predict_poses` call (one batch-K
      forward each); chunk=1 is the reference's per-pose pattern.

  Returns:
    List of (position, OutputData) tuples, each OutputData of batch 1.
  """
  # Collision-filter candidates on the host (numpy window checks, the
  # reference's draw order) ...
  positions = []
  attempts = 0
  start = np.asarray(start_position, np.float32).reshape(1, 3)
  while len(positions) < num_samples and attempts < max_attempts:
    attempts += 1
    noise = rng.uniform([-max_offset_xy, -max_offset_xy, -max_offset_z],
                        [max_offset_xy, max_offset_xy, max_offset_z]
                        ).astype(np.float32)
    if get_proportion_invalid_for_depth(noise, depth_image
                                        ) < collision_threshold:
      positions.append(start + noise[None])
  # ... then synthesise the accepted views `chunk` poses at a time.
  results = []
  for first in range(0, len(positions), chunk):
    block = positions[first:first + chunk]
    outputs = model.predict_poses(np.concatenate(block))
    for i, position in enumerate(block):
      one = type(outputs)(*(
          None if field is None else field[i:i + 1] for field in outputs))
      results.append((position, one))
  return results
