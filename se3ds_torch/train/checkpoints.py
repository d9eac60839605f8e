"""Checkpoints of the SE3DS train state (port of
`se3ds_tpu.train.checkpoints` with `torch.save` in place of Orbax).

One bundle per step, as the reference's tf.train.Checkpoint holds it:
{generator, discriminator, ema_generator, g_optimizer, d_optimizer,
global_step}, in `model_dir/<step>/train_state.pt`. The numeric step
directories are what `utils.task_manager` polls.

Under ZeRO-1 (a world above 1) the bundle is consolidated: every rank
takes part in gathering the shards, rank 0 alone writes, and the file is
the one a world-1 run writes; on restore each rank reads it and keeps its
shards.

`save_ema_generator` writes a generator's serving weights standalone;
`restore_ema_generator` reads them back, or the EMA generator of a
bundle, for `SE3DSModel(ckpt_path=...)`.

`import_tf_checkpoint` maps a TF checkpoint bundle onto a model's state
dict by a caller's name map (`train.tf_import` holds the released
checkpoints' own grammar); the bundle is read without TensorFlow.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from se3ds_torch.models import folding
from se3ds_torch.train import tf_bundle

TRAIN_DONE = 'TRAIN_DONE'
STATE_FILE = 'train_state.pt'


def state_bundle(state) -> Optional[dict]:
  """The 6-way bundle of a `train.state.TrainState`. At a world above 1
  every rank calls it: rank 0 gets the bundle, the others None."""
  bundle = {'step': state.step,
            'generator': state.generator.state_dict(),
            'discriminator': state.discriminator.state_dict(),
            'ema_generator': state.data.gather_state_dict(state.ema,
                                                          state.g_opt.axes),
            'g_optimizer': state.g_opt.state_dict(),
            'd_optimizer': state.d_opt.state_dict()}
  return bundle if state.data.is_chief else None


def load_bundle(state, bundle: dict) -> None:
  """Loads a bundle into `state`'s modules and optimizers, in place
  (this rank's shards of the sharded parts)."""
  state.generator.load_state_dict(bundle['generator'])
  state.discriminator.load_state_dict(bundle['discriminator'])
  state.ema.load_state_dict(state.data.shard_state_dict(
      bundle['ema_generator'], state.ema, state.g_opt.axes))
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
    steps beyond `max_to_keep`. The file is written whole, then renamed.
    At a world above 1 every rank calls it and rank 0 writes; all return
    once the file is there."""
    if step in self.all_steps():
      return
    bundle = state_bundle(state)
    if bundle is not None:
      directory = os.path.dirname(self._path(step))
      os.makedirs(directory, exist_ok=True)
      partial = self._path(step) + '.partial'
      torch.save(bundle, partial)
      os.replace(partial, self._path(step))
      for old in self.all_steps()[:-self.max_to_keep]:
        shutil.rmtree(os.path.join(self.model_dir, str(old)))
    state.data.barrier()

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


# What an Orbax checkpoint directory of the JAX package holds.
_ORBAX_MARKERS = ('_CHECKPOINT_METADATA', '_METADATA', 'manifest.ocdbt')


def _is_orbax(path: str) -> bool:
  """Whether `path` (a directory) is an Orbax checkpoint or a directory of
  them (one per step)."""
  entries = os.listdir(path)
  if any(marker in entries for marker in _ORBAX_MARKERS):
    return True
  return any(_is_orbax(os.path.join(path, e)) for e in entries
             if e.isdigit() and os.path.isdir(os.path.join(path, e)))


def save_ema_generator(path: str, generator: nn.Module) -> None:
  """Saves a generator's serving weights (`folding.serving_state_dict`)
  standalone to the file `path`, written whole, then renamed."""
  partial = path + '.partial'
  torch.save(folding.serving_state_dict(generator), partial)
  os.replace(partial, path)


def restore_ema_generator(path: str, target: Optional[nn.Module] = None,
                          device='cpu') -> Dict[str, torch.Tensor]:
  """Restores the serving state_dict of a generator.

  Args:
    path: a file written by `save_ema_generator`; or the EMA generator of
      a train-state bundle: a `CheckpointManager` directory (its latest
      step), a step directory, or a bundle file.
    target: the serving (`spectral_fold=True`) generator the weights are
      for; a bundle's EMA generator is trainable, and `target`'s folded
      SpectralConvs name the kernels to fold.
    device: where the tensors are returned (and a bundle's folded).

  Raises:
    FileNotFoundError: nothing at `path`, or a directory without a
      checkpoint.
    ValueError: an Orbax checkpoint of the JAX package (restore it there
      and pass its variables to `SE3DSModel(variables=...)`), or a bundle
      without `target`.
  """
  if not os.path.exists(path):
    raise FileNotFoundError(f'No checkpoint at {path!r}.')
  if os.path.isdir(path):
    if not os.path.exists(os.path.join(path, STATE_FILE)):
      if _is_orbax(path):
        raise ValueError(
            f'{path!r} is an Orbax checkpoint of the JAX package, which the '
            'port does not read: restore it with '
            'se3ds_tpu.train.checkpoints.restore_ema_generator and pass its '
            'variables to SE3DSModel(variables=...).')
      manager = CheckpointManager(path)
      latest = manager.latest_step()
      if latest is None:
        raise FileNotFoundError(f'No checkpoint in the directory {path!r}.')
      path = manager._path(latest)
    else:
      path = os.path.join(path, STATE_FILE)
  # Mapped, not read: of a bundle only the EMA generator's tensors are
  # read, and moved to `device`.
  state = torch.load(path, map_location='cpu', weights_only=True, mmap=True)
  bundle = 'ema_generator' in state
  if bundle:
    if target is None:
      raise ValueError('Restoring the EMA generator of a train-state bundle '
                       'needs target=, the serving generator it is for.')
    state = state['ema_generator']
  state = {k: v.to(device) for k, v in state.items()}
  if not bundle:
    return state
  return folding.fold_state_dict(state, folding.spectral_conv_names(target))


def mark_training_done(model_dir: str) -> None:
  """Writes the TRAIN_DONE sentinel."""
  with open(os.path.join(model_dir, TRAIN_DONE), 'w') as f:
    f.write('')


def is_training_done(model_dir: str) -> bool:
  return os.path.exists(os.path.join(model_dir, TRAIN_DONE))


# --- TF checkpoint import ---------------------------------------------------


def import_tf_checkpoint(ckpt_path: str, model: nn.Module,
                         name_map_fn: Optional[Callable[[str], str]] = None
                         ) -> Dict[str, torch.Tensor]:
  """Maps a TF checkpoint onto `model`'s state dict.

  Args:
    ckpt_path: the bundle's prefix.
    model: the module whose state dict's names, shapes and dtypes are the
      template.
    name_map_fn: state-dict key -> TF variable name. The tensor is taken
      as stored (no layout change) and cast to the template's dtype.

  Returns:
    The state dict with the checkpoint's tensors (on the CPU) where names
    resolve; unresolved keys keep the template's tensors and are reported.

  Raises:
    ValueError: a resolved tensor whose shape is not the template's.
  """
  reader = tf_bundle.BundleReader(ckpt_path)
  shapes = reader.get_variable_to_shape_map()
  state, unresolved = {}, []
  for name, template in model.state_dict().items():
    tf_name = name_map_fn(name) if name_map_fn else None
    if not tf_name or tf_name not in shapes:
      unresolved.append(name)
      state[name] = template
      continue
    arr = reader.get_tensor(tf_name)
    if arr.shape != tuple(template.shape):
      raise ValueError(f'{name}: {arr.shape} vs {tuple(template.shape)}')
    state[name] = torch.from_numpy(arr).to(template.dtype)
  if unresolved:
    print(f'[import_tf_checkpoint] {len(unresolved)} unresolved leaves '
          f'(kept template values), e.g. {unresolved[:5]}')
  return state
