"""GAN training and continuous-eval orchestration (port of
`se3ds_tpu.train.trainer`).

One `Trainer` class, the gin configurable `GAN`, takes the JAX trainer's
constructor arguments and defaults (without the mesh ones) and runs on
`device` (the card unless device='cpu' is asked for). It builds the
generator and discriminator from `generator_fn` / `discriminator_fn`
(called with `image_size=`, as the JAX trainer calls them; by default the
gin configurables `ResNetGenerator` and `SNMultiScaleDiscriminator`),
reads TFRecord batches through `data.datasets`, runs train steps in
`num_batched_steps` clusters fed by a prefetch thread, checkpoints the
6-way state bundle, logs scalars and image grids, writes the operative
config, and runs the continuous eval (`test`: checkpoint polling ->
autoregressive rollouts on the exact splat kernel -> per-frame
FID/RMSE/IS -> CSV, event file and PNG dumps).

`train(batches, num_train_steps)` also takes any iterator of numpy
batch dicts in place of the dataset (global batch `train_batch_size *
d_step_per_g_step`, NHWC 'image', 'depth', 'proj_image', 'proj_depth',
'proj_mask', 'blurred_mask').

Training is data-parallel under `torchrun` (`parallel.mesh`: one process
per card, the process group from `WORLD_SIZE`, `RANK` and `LOCAL_RANK`):
each rank reads its shard of the files (or its slice of each chunk of
`batches`), the step averages gradients and normalises over the global
batch, the optimizer state and the EMA are ZeRO-1 shards, and rank 0
alone writes checkpoints, logs, events, image grids and the operative
config. Without `WORLD_SIZE` it runs at world 1. `test` too runs under
torchrun: every rank rolls out its share of each eval batch, rank 0
gathers the pools, computes the scores and alone writes the scores, PNGs
and events.
"""

from __future__ import annotations

import copy
import functools
import logging
import os
import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from se3ds_torch import config as config_lib
from se3ds_torch import device as device_lib
from se3ds_torch.data import datasets as datasets_lib
from se3ds_torch.data import png as png_lib
from se3ds_torch.eval import inception as inception_lib
from se3ds_torch.eval import metrics as metrics_lib
from se3ds_torch.models import discriminator as disc_lib
from se3ds_torch.models import folding
from se3ds_torch.models import generator as gen_lib
from se3ds_torch.parallel import mesh
from se3ds_torch.train import checkpoints as ckpt_lib
from se3ds_torch.train import state as state_lib
from se3ds_torch.utils import image_grid
from se3ds_torch.utils import flops as flops_lib
from se3ds_torch.utils import logger as logger_lib
from se3ds_torch.utils import parameter_overview
from se3ds_torch.utils import task_manager

log = logging.getLogger('se3ds_torch')

_HOURS_IN_DAY = 24
_SECS_IN_HOUR = 3600

BATCH_KEYS = ('image', 'depth', 'proj_image', 'proj_depth', 'proj_mask',
              'blurred_mask')


def gin_generator(image_size: int = 256, **kwargs):
  """gin's `ResNetGenerator`: the port's generator in its trainable form
  (`spectral_fold=False`, the JAX module's default; its eval equals the
  folded serving form). `image_size` is accepted as the JAX module's
  field; the port's generator is fully convolutional and does not read
  it."""
  del image_size
  return gen_lib.ResNetGenerator(**{'spectral_fold': False, **kwargs})


def gin_discriminator(image_size: int = 256, **kwargs):
  """gin's `SNMultiScaleDiscriminator`; `image_size` is accepted and
  unused, as in the JAX module."""
  del image_size
  return disc_lib.SNMultiScaleDiscriminator(**kwargs)


# The port's constructors under the JAX package's gin names.
config_lib.register('ResNetGenerator', gin_generator)
config_lib.register('image_models.ResNetGenerator', gin_generator)
config_lib.register('SNMultiScaleDiscriminator', gin_discriminator)
config_lib.register('image_models.SNMultiScaleDiscriminator',
                    gin_discriminator)
config_lib.register('R2RImageDataset', datasets_lib.R2RImageDataset)
config_lib.register('R2RVideoDataset', datasets_lib.R2RVideoDataset)
config_lib.register('inception_model', inception_lib.inception_model)
config_lib.register('inception_utils.inception_model',
                    inception_lib.inception_model)


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


def host_batch(batch) -> Dict[str, np.ndarray]:
  """The train keys of a batch as float32 numpy; a (N, H, W) depth gains
  its channel axis."""
  out = {k: np.asarray(batch[k], np.float32) for k in BATCH_KEYS}
  if out['depth'].ndim == 3:
    out['depth'] = out['depth'][..., None]
  return out


@config_lib.configurable('GAN', denylist=['model_dir'])
class Trainer:
  """SE3DS GAN trainer (reference GANManager + GAN)."""

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
      parallel_calls: int = 16,  # surface parity; the loader is threaded
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
      generator_fn=None,
      discriminator_fn=None,
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
      # The exact splat: on the card the CUDA kernel csrc/splat_exact.cu.
      eval_splat_mode: str = 'pallas_exact',
      remat: bool = False,
      device=None,
  ):
    del parallel_calls
    if optimizer_type != 'adam':
      raise NotImplementedError(optimizer_type)
    self.model_dir = model_dir
    self.image_size = image_size
    self.seed = seed
    self.beta1, self.beta2 = beta1, beta2
    self.g_lr, self.d_lr = g_lr, d_lr
    self.train_batch_size = train_batch_size
    self.test_batch_size = test_batch_size
    self.global_batch_size = train_batch_size
    self.log_every_steps = log_every_steps
    self.save_every_steps = save_every_steps
    self.eval_every_steps = eval_every_steps
    self.num_epochs = num_epochs
    self.d_step_per_g_step = d_step_per_g_step
    self.num_batched_steps = num_batched_steps
    self.show_num = show_num
    self.shuffle_buffer_size = shuffle_buffer_size
    self.generator_fn = generator_fn
    self.discriminator_fn = discriminator_fn
    self.train_dataset_glob = train_dataset_glob
    self.test_dataset_glob = test_dataset_glob
    self.eval_size = eval_size
    self.test_split = test_split
    self.eval_seq_len = eval_seq_len
    self.predict_depth = predict_depth
    self.max_to_keep = max_to_keep
    self.eval_avg_num = eval_avg_num
    self.eval_splat_mode = eval_splat_mode
    self.device = mesh.init_from_env(device_lib.resolve(device, 'Trainer'))
    self.data = mesh.DataParallel.current()
    self.hp = state_lib.GANHParams(
        lambda_gan=lambda_gan, lambda_kld=lambda_kld, lambda_wc=lambda_wc,
        lambda_depth=lambda_depth, predict_depth=predict_depth,
        dis_use_pred_depth=dis_use_pred_depth, mask_blurred=mask_blurred,
        d_step_per_g_step=d_step_per_g_step, ema_decay=ema_decay,
        ema_init_step=ema_init_step, num_batched_steps=num_batched_steps,
        remat=remat)
    # Serialises train_ds access between the cluster-prefetch thread and
    # the image-grid path.
    self._ds_lock = threading.Lock()
    if model_dir:
      os.makedirs(model_dir, exist_ok=True)

  # -- construction ----------------------------------------------------------

  def _build_models(self):
    """G and D from generator_fn / discriminator_fn or the gin bindings
    (reference gan_manager.py:169-173)."""
    make_g = self.generator_fn or functools.partial(
        config_lib.apply_config, 'ResNetGenerator')
    make_d = self.discriminator_fn or functools.partial(
        config_lib.apply_config, 'SNMultiScaleDiscriminator')
    return (make_g(image_size=self.image_size),
            make_d(image_size=self.image_size))

  def _get_dataset(self):
    """Reference se3ds_trainer.py:95-99."""
    train_ds = config_lib.apply_config('R2RImageDataset',
                                       image_size=self.image_size)
    test_ds = config_lib.apply_config('R2RVideoDataset',
                                      image_size=self.image_size)
    return train_ds, test_ds

  def _create_data(self, for_train: bool = True):
    log.info('Creating Data...')
    train_batch_size = self.global_batch_size * self.d_step_per_g_step
    train_ds, test_ds = self._get_dataset()
    self.train_dataset, self.test_dataset = train_ds, test_ds
    if for_train:
      self.train_ds = train_ds.input_fn(
          split='train', global_batch_size=train_batch_size,
          shuffle=True, shuffle_buffer_size=self.shuffle_buffer_size,
          file_pattern=self.train_dataset_glob, seed=self.seed,
          num_shards=self.data.world_size, shard_index=self.data.rank)
    self.eval_ds_factory = functools.partial(
        test_ds.input_fn, split=self.test_split,
        global_batch_size=self.test_batch_size, shuffle=False,
        file_pattern=self.test_dataset_glob, seed=self.seed, num_epochs=1)
    self.train_num = train_ds.num_examples['train']
    self.eval_num = test_ds.num_examples.get(self.test_split, 0)
    self.train_steps_per_epoch = self.train_num // train_batch_size
    log.info('train_num %s, eval_num %s', self.train_num, self.eval_num)

  def create_state(self) -> state_lib.TrainState:
    """G and D with random weights from `seed` (the same on every rank),
    on the device."""
    rng = torch.Generator(device=self.device).manual_seed(self.seed)
    generator, discriminator = (m.to(self.device)
                                for m in self._build_models())
    folding.init_random_(generator, rng)
    folding.init_random_(discriminator, rng)
    return state_lib.create_train_state(generator, discriminator, self.g_lr,
                                        self.d_lr, self.beta1, self.beta2,
                                        self.data)

  def step_flops(self, batch) -> int:
    """Matmul and conv FLOPs (`utils.flops`) of one `train_step` on a
    batch shaped like `batch` (with `hp.remat`, its recompute too),
    counted on the meta device: no memory, no compute."""
    with torch.device('meta'):
      generator, discriminator = self._build_models()
    state = state_lib.create_train_state(
        generator, discriminator, self.g_lr, self.d_lr, self.beta1,
        self.beta2, mesh.DataParallel())
    shapes = {k: torch.empty(v.shape, device='meta')
              for k, v in batch.items()}
    return flops_lib.count_flops(state_lib.train_step, state, shapes,
                                 self.hp)

  def device_batch(self, batch) -> Dict[str, torch.Tensor]:
    """The train keys of a numpy batch as float32 tensors on the device."""
    return {k: torch.from_numpy(v).to(self.device)
            for k, v in host_batch(batch).items()}

  # -- training --------------------------------------------------------------

  def train(self, batches: Optional[Iterator] = None,
            num_train_steps: Optional[int] = None) -> state_lib.TrainState:
    """Training loop (reference gan_manager.py:387-423).

    Reads the gin-configured R2RImageDataset for `num_epochs *
    train_steps_per_epoch` steps (1 when num_epochs is -1), or `batches`
    for `num_train_steps`. Restores the latest checkpoint of `model_dir`
    or starts from `seed`, writes the operative config, then runs
    `num_batched_steps` clusters, logging scalars every `log_every_steps`
    (raising on a NaN), saving, writing the operative config and logging
    the 'train' image grid every `save_every_steps`, and saving once more
    at the end before marking training done.
    """
    log.info('Create Data and Model...')
    self.global_batch_size = self.train_batch_size
    if batches is None:
      self._create_data()
      num_train_steps = (self.num_epochs * self.train_steps_per_epoch
                         if self.num_epochs != -1 else 1)
    else:
      self.train_ds = (self.data.local_batch(host_batch(b),
                                             self.d_step_per_g_step)
                       for b in batches)
    log.info('Total training steps %s', num_train_steps)

    state = self.create_state()
    ckpt_mgr = ckpt_lib.CheckpointManager(self.model_dir, self.max_to_keep)
    chief = self.data.is_chief
    if ckpt_mgr.restore(state) is not None:
      log.info('Restored from step %s', state.step)
    elif chief:
      log.info('Initializing from scratch.')
      parameter_overview.log_parameter_overview(
          state.generator, msg='Generator Variables')
      parameter_overview.log_parameter_overview(
          state.discriminator, msg='Discriminator Variables')

    start_step = state.step
    train_logger = logger_lib.UniversalLogger(
        self.model_dir, step=start_step,
        num_train_steps=num_train_steps) if chief else None
    task_mgr = task_manager.TaskManagerWithCsvResults(self.model_dir)
    if chief:
      config_lib.write_operative_config(self.model_dir, start_step)
    nbs = self.num_batched_steps

    log.info('Start Training...')
    metric_acc: Dict[str, list] = {}
    cluster_iter = self._prefetch_clusters(nbs)
    last_log_step = start_step
    t_start = time.time()
    try:
      for step in range(start_step, num_train_steps, nbs):
        metrics = state_lib.train_cluster(state, next(cluster_iter), self.hp)
        for k, v in metrics.items():
          metric_acc.setdefault(k, []).append(v)
        completed = step + nbs

        if completed % self.log_every_steps < nbs:
          result = self._reduce_metrics(metric_acc)
          metric_acc = {}
          result['steps_per_sec'] = (completed - last_log_step) / max(
              time.time() - t_start, 1e-7)
          if chief:
            train_logger.log_scalars(step, **result)
          last_log_step = completed
          t_start = time.time()
        if completed % self.save_every_steps < nbs:
          ckpt_mgr.save(state.step, state)
          image_dict, _ = self.get_image_grid(state, 'train')
          if chief:
            config_lib.write_operative_config(self.model_dir, state.step)
            train_logger.log_images(step, **image_dict)
    finally:
      cluster_iter.close()
      if chief:
        train_logger.close()
    ckpt_mgr.save(state.step, state)
    if chief:
      task_mgr.mark_training_done()
    return state

  def _prefetch_clusters(self, nbs: int, depth: int = 2):
    """Yields stacked cluster batches {k: (K, B, ...)} on the device.

    A daemon thread pulls and stacks `nbs` host batches ahead of the
    consumer, so decoding overlaps the device's steps; the consumer
    copies each cluster to the device. A producer failure (the data
    running out, a decode error) reaches the consumer as a RuntimeError
    instead of hanging it. Closing the generator stops the thread.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
      while not stop.is_set():
        try:
          q.put(item, timeout=0.5)
          return
        except queue.Full:
          continue

    def produce():
      try:
        while not stop.is_set():
          with self._ds_lock:
            batches = [host_batch(next(self.train_ds)) for _ in range(nbs)]
          put({k: np.stack([b[k] for b in batches]) for k in BATCH_KEYS})
      except BaseException as exc:  # pylint: disable=broad-except
        put(exc)  # handed to the consumer, which raises it

    threading.Thread(target=produce, daemon=True,
                     name='se3ds-cluster-prefetch').start()
    try:
      while True:
        host = q.get()
        if isinstance(host, BaseException):
          raise RuntimeError('cluster-prefetch producer failed') from host
        yield {k: torch.from_numpy(v).to(self.device)
               for k, v in host.items()}
    finally:
      stop.set()

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
  def get_image_grid(self, state: state_lib.TrainState,
                     name_prefix: str = 'train', display_batch=None):
    """The image grids (reference gan_manager.py:425-617), the raw and the
    EMA generator at eval (circular padding, stored statistics, no `u`
    stored). 'train': one forward on the first chunk of the next training
    batch. 'eval': the two autoregressive rollouts of `display_batch` (a
    numpy video batch) on the eval splat.

    Returns (image_dict, output_dict); for 'eval' the output dict holds
    the EMA rollout's RGB and depth, example-major ((example, frame) in
    order), for the PNG dumps.

    At a world above 1 every rank calls it (the EMA's shards are
    gathered) and rank 0 alone makes the grid; the others get empty
    dicts.
    """
    if name_prefix == 'train':
      with self._ds_lock:  # on every rank: their streams stay in step
        raw = next(self.train_ds)
    ema = self._whole_ema(state)
    if ema is None:
      return {}, {}
    generator, ema = state.generator.eval(), ema.eval()
    host = lambda t: t.float().cpu().numpy()
    tile3 = lambda t: np.tile(host(t), [1, 1, 1, 3])
    output_dict = {}
    if name_prefix == 'train':
      batch = self.device_batch(raw)
      chunk = {k: v[:v.shape[0] // self.d_step_per_g_step]
               for k, v in batch.items()}
      outs, ema_outs = generator(chunk), ema(chunk)
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
    else:
      batch = display_batch
      depth_scale = float(np.asarray(batch['depth_scale'])[0])
      rollout = functools.partial(
          metrics_lib.rollout_generated, batch=batch,
          eval_seq_len=self.eval_seq_len, depth_scale=depth_scale,
          predict_depth=self.predict_depth, splat_mode=self.eval_splat_mode,
          device=self.device)
      gen_frames, _, gen_aux = rollout(generator)
      ema_frames, _, ema_aux = rollout(ema)
      frames = range(self.eval_seq_len)
      cat = lambda seq: np.concatenate([host(seq[i]) for i in frames], 0)
      tile_cat = lambda seq: np.tile(cat(seq), [1, 1, 1, 3])
      real = np.concatenate([np.asarray(batch['image'][:, i])
                             for i in frames], 0)
      real_depth = np.concatenate([np.asarray(batch['depth'][:, i])
                                   for i in frames], 0)
      # The full 9-family eval grid (reference gan_manager.py:560-617);
      # projected/blur_bbox/proj_mask come from the non-EMA rollout, as in
      # the reference's mode == "normal" branch.
      families = {
          'raw_generated': cat(gen_frames),
          'ema_generated': cat(ema_frames),
          'pred_depth': tile_cat(gen_aux['pred_depth']),
          'ema_pred_depth': tile_cat(ema_aux['pred_depth']),
          'real_img': real,
          'real_depth': np.tile(real_depth, [1, 1, 1, 3]),
          'projected': cat(gen_aux['projected']),
          'blur_bbox': tile_cat(gen_aux['blurred_mask']),
          'proj_mask': tile_cat(gen_aux['proj_mask']),
      }
      # The stacks are frame-major; the PNG export indexes them
      # example-major (the reference mixes the two, gan_manager.py:285-291,
      # which the JAX package fixed).
      n = int(batch['image'].shape[0])

      def example_major(stack):
        return np.transpose(
            stack.reshape(self.eval_seq_len, n, *stack.shape[1:]),
            (1, 0, 2, 3, 4)).reshape(-1, *stack.shape[1:])
      output_dict['ema_generated_image'] = example_major(
          families['ema_generated'])
      output_dict['ema_pred_depth'] = example_major(
          families['ema_pred_depth'])

    image_dict = {}
    for key, value in families.items():
      image_dict.update(image_grid.get_grid_image_dict(
          value, self.show_num, f'{name_prefix}_{key}'))
    return image_dict, output_dict

  def _whole_ema(self, state: state_lib.TrainState,
                 every_rank: bool = False):
    """The EMA generator: `state.ema` at world 1; at a larger world one
    built from its gathered ZeRO-1 shards on rank 0, None elsewhere (with
    `every_rank`, on every rank)."""
    if self.data.world_size == 1:
      return state.ema
    whole = self.data.gather_state_dict(state.ema, state.g_opt.axes,
                                        every_rank=every_rank)
    if whole is None:
      return None
    ema = copy.deepcopy(state.generator).requires_grad_(False)
    ema.load_state_dict(whole)
    return ema

  # -- evaluation ------------------------------------------------------------

  def save_eval_images(self, step: int, output_dict) -> None:
    """Per-frame RGB and depth PNGs of the EMA rollout,
    `images/{test_split}/{step}/{frame}/{example}_{rgb,depth}.png`
    (reference gan_manager.py:274-296)."""
    image_output_dir = os.path.join(
        self.model_dir, f'images/{self.test_split}/{step}')
    outputs_to_save = {'rgb': 'ema_generated_image',
                       'depth': 'ema_pred_depth'}
    for suffix, key in outputs_to_save.items():
      image_outputs = output_dict[key]
      num_examples = image_outputs.shape[0] // self.eval_seq_len
      for example_idx in range(num_examples):
        for frame_idx in range(self.eval_seq_len):
          frame_dir = os.path.join(image_output_dir, str(frame_idx))
          os.makedirs(frame_dir, exist_ok=True)
          actual = example_idx * self.eval_seq_len + frame_idx
          frame = (np.clip(image_outputs[actual], 0, 1) * 255).astype(
              np.uint8)
          with open(os.path.join(frame_dir, f'{example_idx}_{suffix}.png'),
                    'wb') as f:
            f.write(png_lib.encode_png(frame))

  def test(self, unit_test: bool = False):
    """Continuous-eval loop (reference gan_manager.py:233-322).

    Polls `model_dir` for checkpoints at `eval_every_steps` until
    TRAIN_DONE (or a day without one) and evaluates each: the eval image
    grid, the PNG dumps, then FID, RMSE and IS per rollout frame for the
    raw and the EMA generator, written to `scores_{test_split}.csv` and
    the event file. `unit_test=True` evaluates the fresh state once and
    returns its results.

    At a world above 1 every rank runs it: each polls `model_dir` and
    evaluates the checkpoint rank 0 evaluates, rolls out its share of
    every eval batch (`EvalMetric(data=...)`), and rank 0 computes the
    scores and alone writes the CSV, the PNGs and the event file; every
    rank returns the scores of a `unit_test`.
    """
    log.info('Start Testing...')
    chief = self.data.is_chief
    self.global_batch_size = self.test_batch_size
    self._create_data(for_train=False)
    task_mgr = task_manager.TaskManagerWithCsvResults(
        self.model_dir, score_file=f'scores_{self.test_split}.csv')
    test_logger = (logger_lib.UniversalLogger(self.model_dir, step=0)
                   if chief else None)
    try:
      metric = metrics_lib.EvalMetric(
          ds_factory=self.eval_ds_factory,
          eval_num=self.eval_size or self.eval_num,
          batch_size=self.test_batch_size,
          avg_num=self.eval_avg_num,
          eval_seq_len=max(self.eval_seq_len, 2),
          predict_depth=self.predict_depth,
          splat_mode=self.eval_splat_mode,
          inception_model=config_lib.apply_config('inception_model').to(
              self.device),
          device=self.device, data=self.data)

      state = self.create_state()
      ckpt_mgr = ckpt_lib.CheckpointManager(self.model_dir, self.max_to_keep)
      display_batch = next(self.eval_ds_factory())

      if unit_test:
        checkpoints = ['test-1']
      else:
        checkpoints = self._agreed(task_mgr.unevaluated_checkpoints(
            timeout=_HOURS_IN_DAY * _SECS_IN_HOUR,
            num_batched_steps=self.num_batched_steps,
            eval_every_steps=self.eval_every_steps))

      for checkpoint_path in checkpoints:
        if not unit_test:
          step_num = int(os.path.basename(checkpoint_path))
          if ckpt_mgr.restore(state, step=step_num) is None:
            log.info('Could not find %s', checkpoint_path)
            continue
        step = state.step
        image_dict, output_dict = self.get_image_grid(
            state, 'eval', display_batch=display_batch)
        image_dict = {f'{k}/{self.test_split}': v
                      for k, v in image_dict.items()}
        if chief:
          self.save_eval_images(step, output_dict)

        time_start = time.time()
        fid, _, rmse, is_score = metric.calculate_fid_score(
            state.generator.eval())
        ema_fid, _, ema_rmse, ema_is = metric.calculate_fid_score(
            self._whole_ema(state, every_rank=True).eval())
        log.info('Step %d, Eval Time %.2f minutes', step,
                 (time.time() - time_start) / 60.0)

        result_dict = {}
        for i in fid:
          curr = dict(fid=fid[i], ema_fid=ema_fid[i], rmse=rmse[i],
                      ema_rmse=ema_rmse[i], inception_score=is_score[i],
                      ema_inception_score=ema_is[i])
          result_dict.update({f'{k}@{i}': v for k, v in curr.items()})
        result_dict = {f'{self.test_split}/eval_image/{k}': v
                       for k, v in result_dict.items()}
        if chief:
          test_logger.log_scalars(step, **result_dict)
          test_logger.log_images(step, **image_dict)
          task_mgr.add_eval_result(checkpoint_path, result_dict, -1)
        if unit_test:
          return result_dict
    finally:
      if test_logger is not None:
        test_logger.close()
    return None

  def _agreed(self, checkpoints: Iterator[str]) -> Iterator[str]:
    """`checkpoints`, each held to rank 0's. Every rank polls the same
    `model_dir` itself (so a wait between checkpoints holds no collective
    open), and so finds the same checkpoints in the same order; a rank
    that does not raises."""
    for path in checkpoints:
      chief_path = self.data.broadcast(path)
      if chief_path != path:
        raise RuntimeError(f'rank {self.data.rank} found {path}, rank 0 '
                           f'{chief_path}')
      yield path
