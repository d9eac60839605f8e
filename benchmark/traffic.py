"""The one generator of the benchmark's traffic, read from data files.

A traffic file (`benchmark/traffic/<name>.json`) names its driver and
holds its parameters; everything the driver sends is drawn here from the
run's seed: synthetic RGB-D room panoramas and camera positions. Every
seed gives the same sizes and the same number of calls; only the scenes
and the positions differ.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
  """An independent stream of the run's seed (any non-negative int)."""
  return np.random.default_rng([seed, sum(map(ord, stream))])


def synthetic_pano(height: int, r: np.random.Generator):
  """An RGB-D room panorama (chip_smoke's, with a drawn phase): walls
  2-6 m away at depth_scale 20 m, 1% holes, textured RGB, class stripes.
  Returns rgb (1, H, W, 3) int32, semantic (1, H, W, 1) int32, depth
  (1, H, W) float32 in [0, 1]."""
  width = 2 * height
  phase = r.uniform(0, 2 * math.pi)
  rows = np.linspace(0, np.pi, height)[:, None]
  cols = np.linspace(0, 2 * np.pi, width)[None, :]
  depth = (0.15 + 0.1 * np.abs(np.cos(rows)) + 0.05 * np.sin(3 * cols + phase)
           + r.uniform(0, 0.01, (height, width)))
  depth[r.random((height, width)) < 0.01] = 0.0
  rgb = (127 + 100 * np.sin(cols * 5 + rows * 3 + phase)[..., None]
         + r.integers(-20, 20, (height, width, 3)))
  sem = ((cols * 6 / (2 * np.pi)).astype(np.int64) % 41 + 1) + 0 * rows
  return (np.clip(rgb, 0, 255).astype(np.int32)[None],
          sem.astype(np.int32)[None, ..., None],
          depth.astype(np.float32)[None])


def in_disc(r: np.random.Generator, count: int, radius: float) -> np.ndarray:
  """`count` (x, y, 0) positions uniform in a disc of `radius` metres."""
  rad = radius * np.sqrt(r.random(count))
  angle = r.uniform(0, 2 * math.pi, count)
  return np.stack([rad * np.cos(angle), rad * np.sin(angle),
                   np.zeros(count)], axis=1).astype(np.float32)


def closed_loop(r: np.random.Generator, points: int, radius: List[float]
                ) -> np.ndarray:
  """A closed circular path of `points` (x, y, 0) positions: radius drawn
  in [radius[0], radius[1]] metres, start and direction drawn."""
  rad = r.uniform(*radius)
  start = r.uniform(0, 2 * math.pi)
  turn = 1.0 if r.random() < 0.5 else -1.0
  angle = start + turn * 2 * math.pi * np.arange(points) / points
  return np.stack([rad * np.cos(angle), rad * np.sin(angle),
                   np.zeros(points)], axis=1).astype(np.float32)


def sampled(seed: int, count: int, every: int) -> np.ndarray:
  """Which of `count` calls the correctness check keeps: one in each
  block of `every`, at an offset drawn from the seed alone (not from the
  timing), so that every seed keeps as many."""
  blocks = -(-count // every)
  picked = (np.arange(blocks) * every
            + rng(seed, 'sample').integers(0, every, blocks))
  keep = np.zeros(count, bool)
  keep[picked[picked < count]] = True
  return keep
