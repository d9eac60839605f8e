"""Synthetic TFRecord fixture writers (a copy of
`se3ds_tpu.data.synthetic`): records in the image-pair and video schemas,
made from a seed; the same seed gives the same bytes."""

from __future__ import annotations

import numpy as np

from se3ds_torch import constants
from se3ds_torch.data import example_pb
from se3ds_torch.data import png
from se3ds_torch.data import tensorproto
from se3ds_torch.data import tfrecord

def make_image_example(height: int = 64, rng=None, index: int = 0,
                       dataset_type: int = 0) -> bytes:
  """Returns one serialized image-pair example (R2RImageDataset schema)."""
  rng = rng if rng is not None else np.random.RandomState(0)
  h, w = height, height * 2
  rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
  proj = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
  depth = rng.randint(0, 65536, (h, w)).astype(np.uint16)
  proj_depth = rng.randint(0, 65536, (h, w)).astype(np.uint16)
  proj_mask = (rng.rand(h, w) > 0.3).astype(np.uint8)
  blurred = np.zeros((h, w), np.uint8)
  blurred[:h // 8] = 1
  blurred[-h // 8:] = 1
  seg = rng.randint(0, constants.NUM_MP3D_CLASSES, (h, w)).astype(np.uint8)
  visible = (1 - blurred).astype(np.uint8)
  features = {
      'scan_id': [b'scan%d' % index],
      'dataset_type': [dataset_type],
      'depth_scale': [float(constants.DEPTH_SCALE)],
      'image/encoded': [png.encode_png(rgb)],
      'image/filename': [b'img%d.png' % index],
      'image/depth': [png.encode_png(depth)],
      'image/visible_mask': [png.encode_png(visible)],
      'image/blurred_mask': [png.encode_png(blurred)],
      'image/segmentation/class/encoded': [png.encode_png(seg)],
      'proj/encoded': [png.encode_png(proj)],
      'proj/depth': [png.encode_png(proj_depth)],
      'proj/mask': [png.encode_png(proj_mask)],
      'bbox': [0.0, 0.0, 1.0, 1.0],
  }
  return example_pb.encode_example(features)

def write_image_fixture(path: str, num_examples: int = 4, height: int = 64,
                        seed: int = 0, dataset_type: int = 0) -> None:
  """Writes image-pair records matching the R2RImageDataset schema."""
  rng = np.random.RandomState(seed)
  with tfrecord.TFRecordWriter(path) as writer:
    for i in range(num_examples):
      writer.write(make_image_example(height, rng, i, dataset_type))

def write_video_fixture(path: str, num_examples: int = 2, height: int = 64,
                        seed: int = 0) -> None:
  """Writes video records matching the R2RVideoDataset schema."""
  rng = np.random.RandomState(seed)
  t = constants.PANO_VIDEO_LENGTH
  h, w = height, height * 2
  with tfrecord.TFRecordWriter(path) as writer:
    for i in range(num_examples):
      rgb = rng.rand(t, h, w, 3).astype(np.float32)
      seg = rng.randint(0, constants.NUM_MP3D_CLASSES,
                        (t, h, w)).astype(np.uint8)
      depth = rng.rand(t, h, w).astype(np.float32)
      position = np.cumsum(
          rng.uniform(-1, 1, (t, 4)).astype(np.float32), axis=0)
      position[:, 3] = 0
      mask = np.ones((t,), np.float32)
      features = {
          'id': [i],
          'scan_id': [b'scan%d' % i],
          'dataset_type': [0],
          'depth_scale': [float(constants.DEPTH_SCALE)],
          'video/num_frames': [t],
          'video/rgb': [tensorproto.encode_tensor(rgb)],
          'video/segmentations': [tensorproto.encode_tensor(seg)],
          'video/depth': [tensorproto.encode_tensor(depth)],
          'video/position': [tensorproto.encode_tensor(position)],
          'video/mask': [tensorproto.encode_tensor(mask)],
      }
      writer.write(example_pb.encode_example(features))
