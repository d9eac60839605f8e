"""Checkpoints of the SE3DS train state (port of
`se3ds_tpu.train.checkpoints` with `torch.save` in place of Orbax).

One bundle per step, as the reference's tf.train.Checkpoint holds it:
{generator, discriminator, ema_generator, g_optimizer, d_optimizer,
global_step}, in `model_dir/<step>/train_state.pt`. The numeric step
directories are what `utils.task_manager` polls.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

TRAIN_DONE = 'TRAIN_DONE'
STATE_FILE = 'train_state.pt'


def state_bundle(state) -> dict:
  """The 6-way bundle of a `train.state.TrainState`."""
  return {'step': state.step,
          'generator': state.generator.state_dict(),
          'discriminator': state.discriminator.state_dict(),
          'ema_generator': state.ema.state_dict(),
          'g_optimizer': state.g_opt.state_dict(),
          'd_optimizer': state.d_opt.state_dict()}


def load_bundle(state, bundle: dict) -> None:
  """Loads a bundle into `state`'s modules and optimizers, in place."""
  state.generator.load_state_dict(bundle['generator'])
  state.discriminator.load_state_dict(bundle['discriminator'])
  state.ema.load_state_dict(bundle['ema_generator'])
  state.g_opt.load_state_dict(bundle['g_optimizer'])
  state.d_opt.load_state_dict(bundle['d_optimizer'])
  state.step = int(bundle['step'])


def bundles_equal(a, b) -> bool:
  """Exact equality of two bundles (nested dicts and lists of tensors and
  numbers), each tensor's dtype and device included."""
  if isinstance(a, dict):
    return (isinstance(b, dict) and a.keys() == b.keys()
            and all(bundles_equal(a[k], b[k]) for k in a))
  if isinstance(a, (list, tuple)):
    return len(a) == len(b) and all(map(bundles_equal, a, b))
  if torch.is_tensor(a):
    return (torch.is_tensor(b) and a.dtype == b.dtype
            and a.device == b.device and torch.equal(a, b))
  return a == b


class CheckpointManager:
  """Save/restore of the train state with retention, as
  tf.train.CheckpointManager(max_to_keep=200)."""

  def __init__(self, model_dir: str, max_to_keep: int = 200):
    self.model_dir = model_dir
    self.max_to_keep = max_to_keep
    os.makedirs(model_dir, exist_ok=True)

  def _path(self, step: int) -> str:
    return os.path.join(self.model_dir, str(step), STATE_FILE)

  def all_steps(self) -> List[int]:
    return sorted(int(name) for name in os.listdir(self.model_dir)
                  if name.isdigit() and os.path.exists(self._path(int(name))))

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def save(self, step: int, state) -> None:
    """Writes the bundle at `step` (a no-op if that step is saved: the
    final save may coincide with a periodic one), then drops the oldest
    steps beyond `max_to_keep`. The file is written whole, then renamed."""
    if step in self.all_steps():
      return
    directory = os.path.dirname(self._path(step))
    os.makedirs(directory, exist_ok=True)
    partial = self._path(step) + '.partial'
    torch.save(state_bundle(state), partial)
    os.replace(partial, self._path(step))
    for old in self.all_steps()[:-self.max_to_keep]:
      shutil.rmtree(os.path.join(self.model_dir, str(old)))

  def restore(self, state, step: Optional[int] = None):
    """Loads the bundle of `step` (default: the latest) into `state`;
    returns `state`, or None if there is no such checkpoint."""
    if step is None:
      step = self.latest_step()
    if step is None or not os.path.exists(self._path(step)):
      return None
    # Through host memory: the optimizers keep their step counts on the
    # CPU, and load_state_dict moves every other tensor to its parameter.
    load_bundle(state, torch.load(self._path(step), map_location='cpu',
                                  weights_only=True))
    return state


def mark_training_done(model_dir: str) -> None:
  """Writes the TRAIN_DONE sentinel."""
  with open(os.path.join(model_dir, TRAIN_DONE), 'w') as f:
    f.write('')


def is_training_done(model_dir: str) -> bool:
  return os.path.exists(os.path.join(model_dir, TRAIN_DONE))
