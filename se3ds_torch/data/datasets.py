"""R2R image and video datasets for SE3DS training and eval, TF-free (a
copy of `se3ds_tpu.data.datasets`).

Host-side numpy pipeline consuming the exact TFRecord schemas of the
reference (datasets/indoor_datasets.py:149-247 for image pairs,
:648-719 for video trajectories). Decoding uses the native C++ loader
where it builds (`data/native_loader.py`) and the pure-Python codecs
otherwise; augmentation matches the reference transform set: random
resize 1-2x, random horizontal/vertical guidance-mask erasure, random
roll + left-right flip, random crop to (S, 2S), and the batch-level
mask multiplication / one-hot transforms. Every draw comes from one
`np.random.RandomState(seed + shard_index)` per pipeline, in the JAX
package's order, so the same files and seed give the same batches bit
for bit.

Host memory: the shuffle buffer holds `shuffle_buffer_size` raw records
(~6.7 GB at lowres.gin's 256 records of a 1024-high image pair), and the
eval transform's one-hot mask is float32 (T, H, 2H, 42) per video
(44 MB at H=128, 704 MB at H=512).

Per-host sharding for multi-host DP: file list is striped by
(shard_index, num_shards), matching the semantics of
`strategy.distribute_datasets_from_function` per-worker pipelines.
"""

from __future__ import annotations

import enum
import os
import queue as queue_lib
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from se3ds_torch import constants
from se3ds_torch.data import example_pb
from se3ds_torch.data import native_loader
from se3ds_torch.data import png
from se3ds_torch.data import tensorproto
from se3ds_torch.data import tfrecord


def _read_records(path: str):
  """TFRecord payloads via the native C++ reader when built."""
  if native_loader.available():
    return native_loader.read_records(path)
  return tfrecord.read_records(path)


class DatasetType(enum.Enum):
  MP3D = 0
  GIBSON = 1  # Unused
  RE10K = 2


def _resize_np(arr: np.ndarray, size, method: str) -> np.ndarray:
  """(H, W, C) resize with half-pixel centers (TF v2 semantics)."""
  h, w = arr.shape[:2]
  out_h, out_w = int(size[0]), int(size[1])
  if (h, w) == (out_h, out_w):
    return arr
  ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
  xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
  if method == 'nearest':
    yi = np.clip(np.floor(ys + 0.5).astype(np.int64), 0, h - 1)
    xi = np.clip(np.floor(xs + 0.5).astype(np.int64), 0, w - 1)
    return arr[yi][:, xi]
  # bilinear
  y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
  x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
  y1 = np.clip(y0 + 1, 0, h - 1)
  x1 = np.clip(x0 + 1, 0, w - 1)
  wy = np.clip(ys - y0, 0, 1)[:, None, None]
  wx = np.clip(xs - x0, 0, 1)[None, :, None]
  arr_f = arr.astype(np.float32)
  top = arr_f[y0][:, x0] * (1 - wx) + arr_f[y0][:, x1] * wx
  bot = arr_f[y1][:, x0] * (1 - wx) + arr_f[y1][:, x1] * wx
  return top * (1 - wy) + bot * wy


def augment(x: np.ndarray, rng: np.random.RandomState,
            random_roll_range: Optional[int] = None,
            random_flip: bool = True) -> np.ndarray:
  """Random horizontal roll + left-right flip (reference
  indoor_datasets.py:34-61). x: (H, W, C)."""
  random_roll_range = random_roll_range or (x.shape[1] // 2)
  roll = rng.randint(-random_roll_range, random_roll_range)
  x = np.roll(x, roll, axis=1)
  if random_flip and rng.rand() < 0.5:
    x = x[:, ::-1]
  return x


def _decode_image_example(raw: bytes, preprocessed_height: int):
  """Parses one image-pair record into decoded numpy features."""
  feats = example_pb.decode_example(raw)
  h = preprocessed_height
  shape = (h, h * 2)

  def get_bytes(key):
    v = feats.get(key, [])
    return bytes(v[0]) if v else b''

  def get_scalar(key, default):
    v = feats.get(key, [])
    return v[0] if v else default

  out = {}
  out['dataset_type'] = int(get_scalar('dataset_type', 0))
  out['depth_scale'] = float(get_scalar('depth_scale', 10.0))
  out['bbox'] = np.asarray(feats.get('bbox', [0.0, 0.0, 0.0, 0.0]),
                           np.float32)

  image = png.decode_png(get_bytes('image/encoded'))
  out['image'] = (image.astype(np.float32) / 255.0).reshape(shape + (3,))
  proj = png.decode_png(get_bytes('proj/encoded'))
  out['proj_image'] = (proj.astype(np.float32) / 255.0).reshape(shape + (3,))
  proj_depth = png.decode_png(get_bytes('proj/depth'))
  out['proj_depth'] = (proj_depth.astype(np.float32) / 65535.0).reshape(shape)
  proj_mask = png.decode_png(get_bytes('proj/mask'))
  out['proj_mask'] = np.clip(proj_mask, 0, 1).astype(np.float32).reshape(shape)
  blurred = png.decode_png(get_bytes('image/blurred_mask'))
  out['blurred_mask'] = np.clip(blurred, 0, 1).astype(np.float32).reshape(
      shape + (1,))
  seg = png.decode_png(get_bytes('image/segmentation/class/encoded'))
  out['segmentation'] = seg.astype(np.int32).reshape(shape)
  out['segmentation_valid'] = np.float32(np.any(out['segmentation'] != 0))
  depth = png.decode_png(get_bytes('image/depth'))
  out['depth'] = (depth.astype(np.float32) / 65535.0).reshape(shape)

  if out['dataset_type'] == DatasetType.RE10K.value:
    visible = png.decode_png(get_bytes('image/visible_mask'))
    visible = np.clip(visible, 0, 1).astype(np.float32).reshape(shape + (1,))
    out['visible_mask'] = visible
    out['blurred_mask'] = 1.0 - visible
  else:
    out['visible_mask'] = np.zeros(shape + (1,), np.float32)
  out['filename'] = get_bytes('image/filename')
  out['scan_id'] = get_bytes('scan_id')
  return out


def device_z(rng: torch.Generator, batch_size: int, z_dim: int = 128
             ) -> torch.Tensor:
  """Draws the noise vector on the generator's device — z_generator=
  'device' (reference base_dataset.py:44-50: 'otherwise use on device
  tf.random').

  The host pipeline omits 'z' in this mode; a train step that consumes z
  calls this with its own `torch.Generator` instead.
  """
  return torch.randn((batch_size, z_dim), generator=rng, device=rng.device)


class BaseDataset:
  """Base dataset: record iteration, sharding, batching, prefetch."""

  def __init__(self, image_size: int,
               num_classes: Optional[int] = constants.NUM_MP3D_CLASSES,
               z_dim: int = 128,
               z_generator: str = 'cpu_generator'):
    self.image_size = image_size
    self.num_classes = num_classes
    self.z_dim = z_dim
    # Reference base_dataset.py:36-50 distinguishes 'cpu_generator'
    # (per-pipeline stateful generator) from 'cpu_random' (global host
    # random op); here BOTH are aliases drawing from the same
    # per-pipeline numpy RNG — the distinction only matters for TF's
    # op-level seeding model, and z is vestigial in this release (the
    # generator's second input is always None). 'device' defers z to
    # the accelerator: the host batch carries no 'z' key and the train
    # step draws it per-step (see device_z below).
    if z_generator not in ('cpu_generator', 'cpu_random', 'device'):
      raise ValueError(f'Unknown z_generator mode: {z_generator!r}')
    self.z_generator = z_generator

  # Subclass API ------------------------------------------------------------

  def get_file_patterns(self, split, file_pattern):
    raise NotImplementedError

  def _parse(self, raw: bytes) -> Dict[str, np.ndarray]:
    raise NotImplementedError

  def _train_transform_fn(self, features, rng):
    return features

  def _eval_transform_fn(self, features, rng):
    return features

  def _train_batch_transform_fn(self, features):
    return features

  @property
  def num_examples(self):
    raise NotImplementedError

  # Pipeline ----------------------------------------------------------------

  def input_fn(self,
               split: str,
               global_batch_size: int,
               shuffle: bool = False,
               shuffle_buffer_size: int = 1000,
               file_pattern=None,
               seed: int = 1,
               num_epochs: Optional[int] = None,
               num_shards: int = 1,
               shard_index: int = 0,
               prefetch: int = 2,
               drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Returns an iterator of batched numpy feature dicts.

    The per-host batch is global_batch_size // num_shards
    (reference base_dataset.py:136-143 per-replica batching).
    """
    files = tfrecord.list_files(self.get_file_patterns(split, file_pattern))
    files = files[shard_index::num_shards]
    batch_size = global_batch_size // num_shards
    rng = np.random.RandomState(seed + shard_index)
    is_train = split == 'train'

    def record_stream():
      epoch = 0
      while num_epochs is None or epoch < num_epochs:
        order = list(files)
        if shuffle:
          rng.shuffle(order)
        for path in order:
          for raw in _read_records(path):
            yield raw
        epoch += 1
        if not files:
          return

    def example_stream():
      buf: List[bytes] = []
      for raw in record_stream():
        if shuffle:
          buf.append(raw)
          if len(buf) >= shuffle_buffer_size:
            idx = rng.randint(len(buf))
            raw_out = buf.pop(idx)
            yield raw_out
        else:
          yield raw
      while buf:
        idx = rng.randint(len(buf))
        yield buf.pop(idx)

    def batch_stream():
      batch: List[Dict[str, np.ndarray]] = []
      for raw in example_stream():
        features = self._parse(raw)
        if is_train:
          features = self._train_transform_fn(features, rng)
        else:
          features = self._eval_transform_fn(features, rng)
        batch.append(features)
        if len(batch) == batch_size:
          out = _stack_batch(batch)
          if is_train:
            out = self._train_batch_transform_fn(out)
          yield out
          batch = []
      if batch and not drop_remainder:
        out = _stack_batch(batch)
        if is_train:
          out = self._train_batch_transform_fn(out)
        yield out

    return _prefetch_iterator(batch_stream(), prefetch)


def _stack_batch(examples: List[Dict[str, np.ndarray]]):
  out = {}
  for key in examples[0]:
    vals = [e[key] for e in examples]
    if isinstance(vals[0], (bytes, str)):
      out[key] = vals
    else:
      out[key] = np.stack([np.asarray(v) for v in vals], axis=0)
  return out


def _prefetch_iterator(it: Iterator, depth: int) -> Iterator:
  """Background-thread prefetch (the reference's ds.prefetch)."""
  if depth <= 0:
    return it
  q: queue_lib.Queue = queue_lib.Queue(maxsize=depth)
  sentinel = object()

  def worker():
    try:
      for item in it:
        q.put(item)
    finally:
      q.put(sentinel)

  t = threading.Thread(target=worker, daemon=True)
  t.start()

  def gen():
    while True:
      item = q.get()
      if item is sentinel:
        return
      yield item

  return gen()


class R2RImageDataset(BaseDataset):
  """Training image-pair dataset (reference R2RImageDataset)."""

  def __init__(self,
               image_size: int = 256,
               preprocessed_image_height: int = 512,
               z_dim: int = 64,
               num_classes: int = constants.NUM_MP3D_CLASSES,
               data_dir: str = 'data/train/',
               return_filename: bool = False,
               horizontal_mask_ratio: float = 0.5,
               vertical_mask_ratio: float = 0.5,
               random_roll_and_flip: bool = True,
               random_crop: bool = True,
               random_resize_max: float = 2.0,
               pad_minval: float = -0.05,
               pad_maxval: float = 0.1,
               re_10k_crop: bool = False,
               num_examples_override: Optional[Dict[str, int]] = None,
               **kwargs):
    super().__init__(image_size=image_size, z_dim=z_dim,
                     num_classes=num_classes, **kwargs)
    self.data_dir = data_dir
    self.num_examples_override = num_examples_override
    self.return_filename = return_filename
    self.preprocessed_image_height = preprocessed_image_height
    self.horizontal_mask_ratio = horizontal_mask_ratio
    self.vertical_mask_ratio = vertical_mask_ratio
    self.random_roll_and_flip = random_roll_and_flip
    self.random_crop = random_crop
    self.random_resize_max = random_resize_max
    self.pad_minval = pad_minval
    self.pad_maxval = pad_maxval
    self.re_10k_crop = re_10k_crop

  def get_file_patterns(self, split=None, file_pattern=None):
    if not file_pattern:
      if split not in ('train', 'val', 'val_unseen', 'val_seen', 'test'):
        raise ValueError(
            f"Expected split to be one of ['train', 'val'], got {split}")
      if split in ('val_seen', 'val_unseen'):
        split = 'val'
      file_pattern = os.path.join(self.data_dir, f'{split}*.tfrecord')
    return file_pattern

  def _parse(self, raw: bytes):
    if native_loader.available() and not self.return_filename:
      return native_loader.decode_image_example(
          raw, self.preprocessed_image_height)
    return _decode_image_example(raw, self.preprocessed_image_height)

  def _transform_fn(self, features, rng):
    """Reference _transform_fn (indoor_datasets.py:263-375)."""
    image = features['image']
    proj_image = features['proj_image']
    segmentation = features['segmentation'][..., None].astype(np.float32)
    depth = features['depth'][..., None]
    proj_depth = features['proj_depth'][..., None]
    proj_mask = features['proj_mask'][..., None]
    blurred_mask = features['blurred_mask']
    height, width, _ = proj_mask.shape

    resize_size = (self.image_size, self.image_size * 2)
    if self.random_crop:
      mult = rng.uniform(1.0, self.random_resize_max)
      resize_size = (int(self.image_size * mult),
                     int(self.image_size * 2 * mult))

    if self.horizontal_mask_ratio > 0:
      mask_ratio = rng.uniform(0, self.horizontal_mask_ratio)
      keep_ratio = 1 - mask_ratio
      image_start = rng.uniform(0, width)
      image_end = (image_start + width * keep_ratio) % width
      cols = np.arange(width, dtype=np.float32)
      if image_start > image_end:
        mask = (cols > image_start) | (cols < image_end)
      else:
        mask = (cols > image_start) & (cols < image_end)
      proj_mask = proj_mask * mask[None, :, None].astype(np.float32)
    if self.vertical_mask_ratio > 0:
      mask_ratio = rng.uniform(0, self.vertical_mask_ratio)
      image_height = height * (1 - mask_ratio)
      image_start = rng.uniform(0, height - image_height)
      rows = np.arange(height, dtype=np.float32)
      mask = (rows > image_start) & (rows < image_start + image_height)
      proj_mask = proj_mask * mask[:, None, None].astype(np.float32)

    semantics = np.concatenate(
        [segmentation, depth, proj_depth, proj_mask, blurred_mask,
         proj_image], axis=-1)
    images = np.clip(_resize_np(image, resize_size, 'bilinear'), 0.0, 1.0)
    semantics = _resize_np(semantics, resize_size, 'nearest')

    if self.random_crop or self.random_roll_and_flip:
      aug = np.concatenate([images, semantics], axis=-1)
      if self.random_roll_and_flip:
        roll_range = int(float(self.image_size) * 2 * self.random_resize_max)
        aug = augment(aug, rng, roll_range)
      if self.random_crop:
        ch, cw = self.image_size, self.image_size * 2
        y0 = rng.randint(0, aug.shape[0] - ch + 1)
        x0 = rng.randint(0, aug.shape[1] - cw + 1)
        aug = aug[y0:y0 + ch, x0:x0 + cw]
      images = aug[..., :3]
      semantics = aug[..., 3:]

    seg, depth, proj_depth, proj_mask, blurred_mask, proj_image = (
        semantics[..., 0:1], semantics[..., 1:2], semantics[..., 2:3],
        semantics[..., 3:4], semantics[..., 4:5], semantics[..., 5:8])

    output = dict(
        image=images.astype(np.float32),
        proj_image=proj_image.astype(np.float32),
        proj_mask=proj_mask.astype(np.float32),
        proj_depth=proj_depth.astype(np.float32),
        segmentation=seg.astype(np.int32),
        segmentation_valid=features['segmentation_valid'],
        depth=depth.astype(np.float32),
        depth_scale=np.float32(features['depth_scale']),
        blurred_mask=blurred_mask.astype(np.float32),
        dataset_type=np.int32(features['dataset_type']),
        bbox=features['bbox'],
    )
    if self.return_filename:
      output['filename'] = features['filename']
    if self.z_generator in ('cpu_generator', 'cpu_random'):
      output['z'] = rng.normal(size=(self.z_dim,)).astype(np.float32)
    return output

  def _transform_fn_re10k(self, features, rng):
    """RE10K variant: crops around the visible region's bounding box with
    random padding/shift before resizing (reference
    indoor_datasets.py:377-535; dispatch commented out there, kept
    available here via re_10k_crop)."""
    image = features['image']
    height, width, _ = image.shape
    proj_image = features['proj_image']
    segmentation = features['segmentation'][..., None].astype(np.float32)
    depth = features['depth'][..., None]
    proj_depth = features['proj_depth'][..., None]
    proj_mask = features['proj_mask'][..., None]
    blurred_mask = features['blurred_mask']

    if self.horizontal_mask_ratio > 0:
      mask_ratio = rng.uniform(0, self.horizontal_mask_ratio)
      keep_ratio = 1 - mask_ratio
      image_start = rng.uniform(0, width)
      image_end = (image_start + width * keep_ratio) % width
      cols = np.arange(width, dtype=np.float32)
      if image_start > image_end:
        mask = (cols > image_start) | (cols < image_end)
      else:
        mask = (cols > image_start) & (cols < image_end)
      proj_mask = proj_mask * mask[None, :, None].astype(np.float32)
    if self.vertical_mask_ratio > 0:
      mask_ratio = rng.uniform(0, self.vertical_mask_ratio)
      image_height = height * (1 - mask_ratio)
      image_start = rng.uniform(0, height - image_height)
      rows = np.arange(height, dtype=np.float32)
      mask = (rows > image_start) & (rows < image_start + image_height)
      proj_mask = proj_mask * mask[:, None, None].astype(np.float32)

    images = image
    semantics = np.concatenate(
        [segmentation, depth, proj_depth, proj_mask, blurred_mask], axis=-1)
    bbox_out = features['bbox']

    if self.re_10k_crop:
      visible = 1 - blurred_mask[..., 0]
      rows_any = np.any(visible > 0, axis=0)
      cols_any = np.any(visible > 0, axis=1)
      if rows_any.any() and cols_any.any():
        pad_prcntg = rng.uniform(self.pad_minval, self.pad_maxval)
        x_shift = rng.uniform(-0.5 * abs(pad_prcntg), 0.5 * abs(pad_prcntg))
        y_shift = rng.uniform(-0.5 * abs(pad_prcntg), 0.5 * abs(pad_prcntg))
        col_idx = np.where(cols_any)[0]
        row_idx = np.where(rows_any)[0]
        y_min = col_idx[0] / height - pad_prcntg + y_shift
        y_max = col_idx[-1] / height + pad_prcntg + y_shift
        x_min = row_idx[0] / width
        x_max = row_idx[-1] / width
        new_h = y_max - y_min
        pad_w = (new_h - (x_max - x_min)) / 2
        x_max = x_max + pad_w + x_shift
        x_min = x_min - pad_w + x_shift
        y_min_i = max(0, int(y_min * height))
        x_min_i = max(0, int(x_min * width))
        y_max_i = min(int(y_max * height), height)
        x_max_i = min(int(x_max * width), width)
        y_max_i = max(y_min_i + 1, y_max_i)
        x_max_i = max(x_min_i + 1, x_max_i)

        if self.random_crop:
          aug = np.concatenate([images, semantics, proj_image], axis=-1)
          aug = aug[y_min_i:y_max_i, x_min_i:x_max_i]
          images = aug[..., :3]
          semantics = aug[..., 3:8]
          proj_image = aug[..., 8:]
          resize_size = (self.image_size, self.image_size * 2)
          images = np.clip(
              _resize_np(images, resize_size, 'bilinear'), 0.0, 1.0)
          semantics = _resize_np(semantics, resize_size, 'nearest')
          proj_image = _resize_np(proj_image, resize_size, 'nearest')
          bbox_out = np.asarray([x_min_i, y_min_i, x_max_i, y_max_i],
                                np.float32)

    seg, depth, proj_depth, proj_mask, blurred_mask = (
        semantics[..., 0:1], semantics[..., 1:2], semantics[..., 2:3],
        semantics[..., 3:4], semantics[..., 4:5])

    output = dict(
        image=images.astype(np.float32),
        proj_image=proj_image.astype(np.float32),
        proj_mask=proj_mask.astype(np.float32),
        proj_depth=proj_depth.astype(np.float32),
        segmentation=seg.astype(np.int32),
        segmentation_valid=features['segmentation_valid'],
        depth=depth.astype(np.float32),
        depth_scale=np.float32(features['depth_scale']),
        blurred_mask=blurred_mask.astype(np.float32),
        dataset_type=np.int32(features['dataset_type']),
        bbox=bbox_out,
    )
    if self.return_filename:
      output['filename'] = features['filename']
    if self.z_generator in ('cpu_generator', 'cpu_random'):
      output['z'] = rng.normal(size=(self.z_dim,)).astype(np.float32)
    return output

  def _train_transform_fn(self, features, rng):
    if self.re_10k_crop and features['dataset_type'] == DatasetType.RE10K.value:
      return self._transform_fn_re10k(features, rng)
    return self._transform_fn(features, rng)

  def _eval_transform_fn(self, features, rng):
    features = self._train_transform_fn(features, rng)
    features['one_hot_mask'] = _one_hot(
        features['segmentation'][..., 0], self.num_classes)
    return features

  def _train_batch_transform_fn(self, features):
    """Reference batch transform (indoor_datasets.py:553-597)."""
    features = dict(features)
    features['proj_image'] = features['proj_image'] * features['proj_mask']
    features['proj_depth'] = features['proj_depth'] * features['proj_mask']
    features['one_hot_mask'] = _one_hot(
        features['segmentation'][..., 0], self.num_classes)
    return features

  @property
  def num_examples(self):
    # Hardcoded counts mirror the reference (indoor_datasets.py); the
    # override is a test/gin knob for short epochs on fixture data.
    if self.num_examples_override is not None:
      return self.num_examples_override
    return {'train': 183_621, 'val': 4671}


def _one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
  return np.eye(num_classes, dtype=np.float32)[
      np.clip(labels, 0, num_classes - 1)]


class R2RVideoDataset(BaseDataset):
  """Eval video-trajectory dataset (reference R2RVideoDataset).

  The `video/pathdreamer_*` features are parsed only when present,
  fixing the reference's undeclared-feature bug
  (indoor_datasets.py:699-713).
  """

  def __init__(self,
               image_size: int = 256,
               preprocessed_image_height: int = 512,
               num_classes: int = constants.NUM_MP3D_CLASSES,
               data_dir: str = 'data/val/',
               return_filename: bool = False,
               video_length: int = constants.PANO_VIDEO_LENGTH,
               horizontal_mask_ratio: float = 0.0,
               **kwargs):
    super().__init__(image_size=image_size, num_classes=num_classes, **kwargs)
    self.preprocessed_image_height = preprocessed_image_height
    self.data_dir = data_dir
    self.return_filename = return_filename
    self.video_length = video_length
    self.horizontal_mask_ratio = horizontal_mask_ratio

  def get_file_patterns(self, split=None, file_pattern=None):
    if not file_pattern:
      if split not in ('train', 'val_seen', 'val_unseen'):
        raise ValueError(
            "Expected split to be one of ['train', 'val_seen', "
            f"'val_unseen'], got {split}")
      file_pattern = os.path.join(self.data_dir, f'{split}*.tfrecord')
    return file_pattern

  def _parse(self, raw: bytes):
    feats = example_pb.decode_example(raw)
    t = constants.PANO_VIDEO_LENGTH
    h = self.preprocessed_image_height
    shape = (t, h, h * 2)

    def tensor(key):
      v = feats.get(key, [])
      return tensorproto.decode_tensor(bytes(v[0])) if v else None

    def scalar(key, default):
      v = feats.get(key, [])
      return v[0] if v else default

    out = {}
    out['id'] = np.int64(scalar('id', 0))
    out['dataset_type'] = np.int32(scalar('dataset_type', 0))
    out['depth_scale'] = np.float32(scalar('depth_scale',
                                           constants.DEPTH_SCALE))
    out['image'] = tensor('video/rgb').reshape(shape + (3,))
    out['position'] = tensor('video/position').reshape(t, 4)
    out['mask'] = tensor('video/mask').reshape(t)
    out['segmentation'] = tensor('video/segmentations').astype(
        np.uint8).reshape(shape)
    out['depth'] = tensor('video/depth').reshape(shape)
    pd_seg = tensor('video/pathdreamer_segmentations')
    out['pathdreamer_segmentation'] = (
        pd_seg.astype(np.uint8).reshape(shape) if pd_seg is not None
        else np.zeros(shape, np.uint8))
    pd_depth = tensor('video/pathdreamer_depth')
    out['pathdreamer_depth'] = (
        pd_depth.reshape(shape) if pd_depth is not None
        else np.zeros(shape, np.float32))
    if self.return_filename:
      out['scan_id'] = bytes(feats.get('scan_id', [b''])[0])
    return out

  def _transform_fn(self, features, rng):
    size = (self.image_size, self.image_size * 2)
    t = features['image'].shape[0]

    def resize_seq(x, method):
      return np.stack([_resize_np(x[i], size, method) for i in range(t)], 0)

    image = resize_seq(features['image'], 'bilinear')
    segmentation = resize_seq(
        features['segmentation'][..., None].astype(np.float32), 'nearest')
    pd_seg = resize_seq(
        features['pathdreamer_segmentation'][..., None].astype(np.float32),
        'nearest')
    depth = resize_seq(features['depth'][..., None], 'nearest')
    pd_depth = resize_seq(features['pathdreamer_depth'][..., None], 'nearest')

    if self.horizontal_mask_ratio > 0:
      width = self.image_size * 2
      mask_start = rng.uniform(0, width)
      mask_end = (mask_start + width * (1 - self.horizontal_mask_ratio)
                  ) % width
      cols = np.arange(width, dtype=np.float32)
      if mask_start > mask_end:
        mask = (cols > mask_start) | (cols < mask_end)
      else:
        mask = (cols > mask_start) & (cols < mask_end)
      masked_image = image * mask[None, None, :, None].astype(np.float32)
    else:
      masked_image = image

    output = dict(
        id=features['id'],
        image=masked_image.astype(np.float32),
        original_image=image.astype(np.float32),
        position=features['position'].astype(np.float32),
        mask=features['mask'].astype(np.float32),
        segmentation=segmentation.astype(np.int32),
        pathdreamer_segmentation=pd_seg.astype(np.int32),
        depth=depth.astype(np.float32),
        pathdreamer_depth=pd_depth.astype(np.float32),
        depth_scale=np.float32(features['depth_scale']),
        dataset_type=np.int32(features['dataset_type']))
    if self.z_generator in ('cpu_generator', 'cpu_random'):
      output['z'] = rng.normal(size=(self.z_dim,)).astype(np.float32)
    return output

  def _train_transform_fn(self, features, rng):
    return self._transform_fn(features, rng)

  def _eval_transform_fn(self, features, rng):
    features = self._transform_fn(features, rng)
    features['one_hot_mask'] = _one_hot(
        features['segmentation'][..., 0], self.num_classes)
    return features

  @property
  def num_examples(self):
    return {'train': 4675, 'val_unseen': 783, 'val_seen': 340}
