"""GAN training orchestration (port of `se3ds_tpu.train.trainer`'s
training half).

`Trainer` takes the JAX trainer's constructor arguments and defaults,
without the mesh ones and gin, so a recipe's `GAN.*` bindings apply as
they are; those of the data pipeline and of the continuous eval are kept
for the slices that port them. The generator and discriminator come
from `generator_fn` / `discriminator_fn` (callables with no arguments).
It runs on `device` (the card unless device='cpu' is asked for).

The data pipeline is not ported, so `train` reads an iterator of numpy
batch dicts (global batch `train_batch_size * d_step_per_g_step`, NHWC
'image', 'depth', 'proj_image', 'proj_depth', 'proj_mask',
'blurred_mask') and the caller gives the number of steps the JAX trainer
derives from its dataset. The continuous eval (`Trainer.test`) is not
ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from se3ds_torch import device as device_lib
from se3ds_torch.models import discriminator as disc_lib
from se3ds_torch.models import folding
from se3ds_torch.models import generator as gen_lib
from se3ds_torch.train import checkpoints as ckpt_lib
from se3ds_torch.train import state as state_lib
from se3ds_torch.utils import image_grid
from se3ds_torch.utils import logger as logger_lib
from se3ds_torch.utils import parameter_overview
from se3ds_torch.utils import task_manager

log = logging.getLogger('se3ds_torch')

BATCH_KEYS = ('image', 'depth', 'proj_image', 'proj_depth', 'proj_mask',
              'blurred_mask')

# configs/lowres/lowres.gin: its GAN bindings (but the batch, the schedule
# and the data paths) and its model widths.
LOWRES = dict(image_size=128, seed=0, beta1=0.5, g_lr=0.0001, d_lr=0.0004,
              d_step_per_g_step=2, mask_blurred=True, lambda_kld=10.0,
              lambda_gan=1.0, lambda_depth=100.0, lambda_wc=10.0,
              dis_use_pred_depth=True, predict_depth=True, show_num=25)
LOWRES_GENERATOR = dict(gen_dims=128, resnet_version='101')
LOWRES_DISCRIMINATOR = dict(dis_dims=128, n_dis=2, n_layers=6)


def synthetic_batches(batch: int, height: int, seed: int) -> Iterator:
  """Endless numpy training batches shaped as the data pipeline yields
  them, made from `seed`: RGB in [0, 1], depth in [-0.1, 1.1] (outside
  (0, 1) is invalid), the guidance RGB-D, 0/1 guidance and blurred-pole
  masks."""
  rs = np.random.RandomState(seed)
  width = 2 * height
  while True:
    yield {
        'image': rs.rand(batch, height, width, 3).astype(np.float32),
        'depth': rs.uniform(-0.1, 1.1, (batch, height, width, 1)).astype(
            np.float32),
        'proj_image': rs.rand(batch, height, width, 3).astype(np.float32),
        'proj_depth': rs.rand(batch, height, width, 1).astype(np.float32),
        'proj_mask': (rs.rand(batch, height, width, 1) > 0.3).astype(
            np.float32),
        'blurred_mask': (rs.rand(batch, height, width, 1) > 0.9).astype(
            np.float32)}


class Trainer:
  """SE3DS GAN trainer (reference GANManager + GAN), training only."""

  def __init__(
      self,
      model_dir: str,
      image_size: int = 128,
      seed: int = 1,
      optimizer_type: str = 'adam',
      beta1: float = 0.0,
      beta2: float = 0.999,
      g_lr: float = 0.0002,
      d_lr: float = 0.0002,
      train_batch_size: int = 128,
      test_batch_size: int = 128,
      parallel_calls: int = 16,
      log_every_steps: int = 1000,
      save_every_steps: int = 2000,
      eval_every_steps: int = 2000,
      num_epochs: int = 100,
      d_step_per_g_step: int = 1,
      num_batched_steps: int = 5,
      show_num: int = 16,
      shuffle_buffer_size: int = 1000,
      ema_decay: float = 0.999,
      ema_init_step: int = 0,
      generator_fn: Optional[Callable[[], torch.nn.Module]] = None,
      discriminator_fn: Optional[Callable[[], torch.nn.Module]] = None,
      train_dataset_glob: Optional[str] = None,
      test_dataset_glob: Optional[str] = None,
      eval_size: Optional[int] = 10000,
      test_split: str = 'val_seen',
      eval_seq_len: int = 4,
      predict_depth: bool = False,
      lambda_gan: float = 1.0,
      lambda_kld: float = 10.0,
      lambda_wc: float = 10.0,
      lambda_depth: float = 100.0,
      dis_use_pred_depth: bool = True,
      mask_blurred: bool = False,
      max_to_keep: int = 200,
      eval_avg_num: int = 3,
      eval_splat_mode: str = 'pallas_exact',
      remat: bool = False,
      device=None,
  ):
    if optimizer_type != 'adam':
      raise NotImplementedError(optimizer_type)
    if remat:
      raise NotImplementedError('remat is not ported yet')
    self.model_dir = model_dir
    self.image_size = image_size
    self.seed = seed
    self.beta1, self.beta2 = beta1, beta2
    self.g_lr, self.d_lr = g_lr, d_lr
    self.train_batch_size = train_batch_size
    self.log_every_steps = log_every_steps
    self.save_every_steps = save_every_steps
    self.d_step_per_g_step = d_step_per_g_step
    self.num_batched_steps = num_batched_steps
    self.show_num = show_num
    # Read by the data pipeline and the continuous eval (not ported yet).
    self.test_batch_size = test_batch_size
    self.parallel_calls = parallel_calls
    self.eval_every_steps = eval_every_steps
    self.num_epochs = num_epochs
    self.shuffle_buffer_size = shuffle_buffer_size
    self.train_dataset_glob = train_dataset_glob
    self.test_dataset_glob = test_dataset_glob
    self.eval_size = eval_size
    self.test_split = test_split
    self.eval_seq_len = eval_seq_len
    self.eval_avg_num = eval_avg_num
    self.eval_splat_mode = eval_splat_mode
    self.generator_fn = generator_fn or (
        lambda: gen_lib.ResNetGenerator(spectral_fold=False))
    self.discriminator_fn = (discriminator_fn
                             or disc_lib.SNMultiScaleDiscriminator)
    self.predict_depth = predict_depth
    self.max_to_keep = max_to_keep
    self.device = device_lib.resolve(device, 'Trainer')
    self.hp = state_lib.GANHParams(
        lambda_gan=lambda_gan, lambda_kld=lambda_kld, lambda_wc=lambda_wc,
        lambda_depth=lambda_depth, predict_depth=predict_depth,
        dis_use_pred_depth=dis_use_pred_depth, mask_blurred=mask_blurred,
        d_step_per_g_step=d_step_per_g_step, ema_decay=ema_decay,
        ema_init_step=ema_init_step, num_batched_steps=num_batched_steps,
        remat=remat)
    if model_dir:
      os.makedirs(model_dir, exist_ok=True)

  # -- construction ----------------------------------------------------------

  def create_state(self) -> state_lib.TrainState:
    """G and D with random weights from `seed`, on the device."""
    rng = torch.Generator(device=self.device).manual_seed(self.seed)
    generator = self.generator_fn().to(self.device)
    discriminator = self.discriminator_fn().to(self.device)
    folding.init_random_(generator, rng)
    folding.init_random_(discriminator, rng)
    return state_lib.create_train_state(generator, discriminator, self.g_lr,
                                        self.d_lr, self.beta1, self.beta2)

  def device_batch(self, batch) -> Dict[str, torch.Tensor]:
    """The train keys of a numpy batch as float32 tensors on the device;
    a (N, H, W) depth gains its channel axis."""
    out = {}
    for key in BATCH_KEYS:
      value = torch.from_numpy(np.asarray(batch[key], np.float32))
      if key == 'depth' and value.dim() == 3:
        value = value[..., None]
      out[key] = value.to(self.device)
    return out

  # -- training --------------------------------------------------------------

  def train(self, batches: Iterator, num_train_steps: int
            ) -> state_lib.TrainState:
    """Training loop (reference gan_manager.py:387-423): restores the
    latest checkpoint of `model_dir` or starts from `seed`, then runs
    `num_batched_steps` clusters of train steps up to `num_train_steps`,
    logging scalars every `log_every_steps` (raising on a NaN), saving and
    logging the 'train' image grid every `save_every_steps`, and saving
    once more at the end before marking training done."""
    log.info('Create Model...')
    state = self.create_state()
    ckpt_mgr = ckpt_lib.CheckpointManager(self.model_dir, self.max_to_keep)
    if ckpt_mgr.restore(state) is not None:
      log.info('Restored from step %s', state.step)
    else:
      log.info('Initializing from scratch.')
      parameter_overview.log_parameter_overview(
          state.generator, msg='Generator Variables')
      parameter_overview.log_parameter_overview(
          state.discriminator, msg='Discriminator Variables')

    start_step = state.step
    train_logger = logger_lib.UniversalLogger(
        self.model_dir, step=start_step, num_train_steps=num_train_steps)
    task_mgr = task_manager.TaskManagerWithCsvResults(self.model_dir)
    nbs = self.num_batched_steps

    log.info('Start Training...')
    metric_acc: Dict[str, list] = {}
    last_log_step = start_step
    t_start = time.time()
    try:
      for step in range(start_step, num_train_steps, nbs):
        cluster = [self.device_batch(next(batches)) for _ in range(nbs)]
        stacked = {k: torch.stack([b[k] for b in cluster])
                   for k in BATCH_KEYS}
        metrics = state_lib.train_cluster(state, stacked, self.hp)
        for k, v in metrics.items():
          metric_acc.setdefault(k, []).append(v)
        completed = step + nbs

        if completed % self.log_every_steps < nbs:
          result = self._reduce_metrics(metric_acc)
          metric_acc = {}
          result['steps_per_sec'] = (completed - last_log_step) / max(
              time.time() - t_start, 1e-7)
          train_logger.log_scalars(step, **result)
          last_log_step = completed
          t_start = time.time()
        if completed % self.save_every_steps < nbs:
          ckpt_mgr.save(state.step, state)
          image_dict = self.get_image_grid(state, next(batches))
          train_logger.log_images(step, **image_dict)
      ckpt_mgr.save(state.step, state)
      task_mgr.mark_training_done()
    finally:
      train_logger.close()
    return state

  def _reduce_metrics(self, acc: Dict[str, list]) -> Dict[str, float]:
    result = {}
    for k, vals in acc.items():
      m = float(torch.mean(torch.stack(vals)))
      if np.isnan(m):
        raise ValueError(f'NaN losses recorded for {k}.')
      result[k] = m
    return result

  # -- image grids -----------------------------------------------------------

  @torch.no_grad()
  def get_image_grid(self, state: state_lib.TrainState, batch,
                     name_prefix: str = 'train') -> Dict[str, np.ndarray]:
    """The 'train' grid (reference gan_manager.py:425-617): the raw and
    the EMA generator at eval (circular padding, stored statistics, no
    `u` stored) on the first chunk of a numpy batch."""
    batch = self.device_batch(batch)
    chunk = {k: v[:v.shape[0] // self.d_step_per_g_step]
             for k, v in batch.items()}
    outs = state.generator.eval()(chunk)
    ema_outs = state.ema.eval()(chunk)
    host = lambda t: t.float().cpu().numpy()
    tile3 = lambda t: np.tile(host(t), [1, 1, 1, 3])
    families = {
        'raw_generated': host(outs[6]),
        'ema_generated': host(ema_outs[6]),
        'pred_depth': tile3(outs[3]),
        'ema_pred_depth': tile3(ema_outs[3]),
        'real_img': host(chunk['image']),
        'real_depth': tile3(chunk['depth']),
        'projected': host(chunk['proj_image']),
        'blur_bbox': tile3(chunk['blurred_mask']),
        'proj_mask': tile3(chunk['proj_mask']),
    }
    image_dict = {}
    for key, value in families.items():
      image_dict.update(image_grid.get_grid_image_dict(
          value, self.show_num, f'{name_prefix}_{key}'))
    return image_dict
