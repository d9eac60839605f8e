"""Train/eval coordination via the filesystem (a copy of
`se3ds_tpu.utils.task_manager`): TRAIN_DONE sentinel, checkpoint polling with
timeout, CSV results with operative-config provenance."""

from __future__ import annotations

import csv
import glob
import logging
import os
import re
import time
from typing import Any, Dict, Iterable, Optional

log = logging.getLogger('se3ds_torch')


def _parse_gin_config(config_path: str) -> Dict[str, str]:
  """Parses a gin config into a flat string dict (provenance only)."""
  config: Dict[str, str] = {}
  with open(config_path) as f:
    for raw in f.read().splitlines():
      line = raw.split('#', 1)[0].strip()
      if not line or line.startswith(('import ', 'from ', 'include ')):
        continue
      if '=' in line:
        name, value = line.split('=', 1)
        config[name.strip()] = value.strip()
  return config


class TaskManager:
  """Polls a model dir for checkpoints to evaluate."""

  def __init__(self, model_dir: str):
    self._model_dir = model_dir

  @property
  def model_dir(self) -> str:
    return self._model_dir

  def mark_training_done(self) -> None:
    with open(os.path.join(self.model_dir, 'TRAIN_DONE'), 'w') as f:
      f.write('')

  def is_training_done(self) -> bool:
    return os.path.exists(os.path.join(self.model_dir, 'TRAIN_DONE'))

  def add_eval_result(self, checkpoint_path: str,
                      result_dict: Dict[str, Any],
                      default_value: int = -1) -> None:
    pass

  def _get_checkpoints_with_results(self):
    return set()

  def _list_checkpoints(self):
    """Checkpoint layout: model_dir/<step>/ directories with numeric names."""
    out = []
    if not os.path.isdir(self._model_dir):
      return out
    for name in os.listdir(self._model_dir):
      full = os.path.join(self._model_dir, name)
      if os.path.isdir(full) and name.isdigit():
        out.append(full)
    return out

  def unevaluated_checkpoints(self, timeout: int = 3600 * 8,
                              num_batched_steps: int = 1,
                              eval_every_steps: Optional[int] = None,
                              poll_interval: float = 5.0
                              ) -> Iterable[str]:
    """Yields checkpoint paths not yet evaluated; polls until timeout or
    TRAIN_DONE (reference task_manager.py:84-141)."""
    log.info('Looking for checkpoints in %s', self._model_dir)
    evaluated = self._get_checkpoints_with_results()
    last_eval = time.time()
    while True:
      checkpoints = set(self._list_checkpoints())
      unevaluated = checkpoints - evaluated
      step_and_ckpt = sorted(
          (int(os.path.basename(x)), x) for x in unevaluated)
      pending = []
      for step, ckpt in step_and_ckpt:
        if eval_every_steps:
          if step > num_batched_steps and (
              step % eval_every_steps < num_batched_steps):
            pending.append(ckpt)
        else:
          pending.append(ckpt)
      for ckpt in pending:
        yield ckpt
      if pending:
        evaluated |= set(pending)
        last_eval = time.time()
        continue
      if time.time() - last_eval > timeout or self.is_training_done():
        return
      time.sleep(poll_interval)


class TaskManagerWithCsvResults(TaskManager):
  """Task manager that appends results + operative config to a CSV."""

  def __init__(self, model_dir: str, score_file: Optional[str] = None):
    super().__init__(model_dir)
    if score_file is None:
      score_file = os.path.join(model_dir, 'scores.csv')
    else:
      score_file = os.path.join(model_dir, score_file)
    self._score_file = score_file

  def _get_checkpoints_with_results(self):
    if not os.path.exists(self._score_file):
      return set()
    with open(self._score_file) as f:
      reader = csv.DictReader(f)
      return {r['checkpoint_path'] for r in reader}

  def add_eval_result(self, checkpoint_path: str,
                      result_dict: Dict[str, Any],
                      default_value: int = -1) -> None:
    step = int(os.path.basename(checkpoint_path).split('-')[-1])
    config = self._get_config_for_step(step)
    csv_header = (['checkpoint_path', 'step'] + sorted(result_dict)
                  + sorted(config))
    write_header = not os.path.exists(self._score_file)
    row = dict(checkpoint_path=checkpoint_path, step=str(step), **config)
    for k, v in result_dict.items():
      row[k] = '{:.3f}'.format(v) if isinstance(v, float) else v
    os.makedirs(os.path.dirname(self._score_file) or '.', exist_ok=True)
    with open(self._score_file, 'a') as f:
      writer = csv.DictWriter(f, fieldnames=csv_header,
                              extrasaction='ignore')
      if write_header:
        writer.writeheader()
      writer.writerow(row)

  def _get_config_for_step(self, step: int) -> Dict[str, str]:
    saved = glob.glob(
        os.path.join(self.model_dir, 'operative_config-*.gin'))
    if not saved:
      return {}
    get_step = lambda fn: int(
        re.findall(r'operative_config-(\d+).gin', fn)[0])
    config_steps = [get_step(fn) for fn in saved]
    candidates = sorted(s for s in config_steps if s <= step)
    if not candidates:
      return {}
    path = os.path.join(self.model_dir,
                        f'operative_config-{candidates[-1]}.gin')
    return _parse_gin_config(path)
