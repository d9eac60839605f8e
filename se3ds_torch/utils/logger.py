"""Scalar/image logging to TensorBoard event files, mirrored to INFO
(port of `se3ds_tpu.utils.logger`).

Writes tfevents files directly (TFRecord framing of Event/Summary
messages encoded by hand), so TensorBoard reads them without TF or
protobuf in the process.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import time
from typing import Callable, Optional

import numpy as np

from se3ds_torch.data import example_pb as pb
from se3ds_torch.data import png as png_lib
from se3ds_torch.data import tfrecord


def _encode_summary_value_scalar(tag: str, value: float) -> bytes:
  v = bytearray()
  pb.encode_len_delimited(v, 1, tag.encode('utf-8'))  # tag
  pb.write_varint(v, (2 << 3) | 5)  # simple_value, fixed32
  v.extend(struct.pack('<f', float(value)))
  return bytes(v)


def _encode_summary_value_image(tag: str, image: np.ndarray) -> bytes:
  """Summary.Value with image (field 4: Summary.Image)."""
  h, w = image.shape[:2]
  c = image.shape[2] if image.ndim == 3 else 1
  img = bytearray()
  for field, value in ((1, h), (2, w), (3, c)):  # height, width, colorspace
    pb.write_varint(img, field << 3)
    pb.write_varint(img, value)
  pb.encode_len_delimited(img, 4, png_lib.encode_png(image.astype(np.uint8)))
  v = bytearray()
  pb.encode_len_delimited(v, 1, tag.encode('utf-8'))
  pb.encode_len_delimited(v, 4, bytes(img))
  return bytes(v)


def _encode_event(step: int, summary_values) -> bytes:
  summary = bytearray()
  for value in summary_values:
    pb.encode_len_delimited(summary, 1, value)
  event = bytearray()
  pb.write_varint(event, (1 << 3) | 1)  # wall_time, double
  event.extend(struct.pack('<d', time.time()))
  pb.write_varint(event, 2 << 3)  # step, varint
  pb.write_varint(event, step)
  pb.encode_len_delimited(event, 5, bytes(summary))  # summary
  return bytes(event)


class SummaryWriter:
  """Minimal tfevents writer (TFRecord-framed Event protos)."""

  def __init__(self, logdir: str):
    os.makedirs(logdir, exist_ok=True)
    fname = (f'events.out.tfevents.{int(time.time())}.'
             f'{socket.gethostname()}.{os.getpid()}.v2')
    self.path = os.path.join(logdir, fname)
    self._writer = tfrecord.TFRecordWriter(self.path)
    version = bytearray()  # the file-version event
    pb.write_varint(version, (1 << 3) | 1)
    version.extend(struct.pack('<d', time.time()))
    pb.encode_len_delimited(version, 3, b'brain.Event:2')
    self._writer.write(bytes(version))

  def scalar(self, tag: str, value: float, step: int):
    self._writer.write(_encode_event(
        step, [_encode_summary_value_scalar(tag, value)]))

  def image(self, tag: str, image: np.ndarray, step: int):
    self._writer.write(_encode_event(
        step, [_encode_summary_value_image(tag, image)]))

  def flush(self):
    self._writer.flush()

  def close(self):
    self._writer.close()


class UniversalLogger:
  """Scalar/image logger (reference utils/logger.py:29-80)."""

  def __init__(self, workdir: str, step: int,
               num_train_steps: Optional[int] = None,
               logging_fn: Optional[Callable[[str], None]] = None):
    self.summary_writer = SummaryWriter(workdir)
    self._num_train_steps = num_train_steps
    self._print = logging_fn or logging.getLogger('se3ds_torch').info
    self._last_time = time.time()
    self._last_step = step

  def log_scalars(self, step: int, **kwargs):
    log_msg = ', '.join(f'{k} = {v:.3f}' for k, v in sorted(kwargs.items()))
    self._print(f'[{step}] {log_msg}')
    for k, v in sorted(kwargs.items()):
      self.summary_writer.scalar(k, float(v), step)
    self.summary_writer.flush()

  def log_images(self, step: int, max_outputs: int = 10, **kwargs):
    for k, v in sorted(kwargs.items()):
      v = np.asarray(v)
      if v.ndim == 4:
        for i in range(min(v.shape[0], max_outputs)):
          tag = k if v.shape[0] == 1 else f'{k}/{i}'
          self.summary_writer.image(tag, v[i], step)
      else:
        self.summary_writer.image(k, v, step)
    self.summary_writer.flush()

  def report_progress(self, step: int):
    """Steps/sec + ETA (reference logger.py:73-80)."""
    now = time.time()
    dt = max(now - self._last_time, 1e-7)
    steps_per_sec = (step - self._last_step) / dt
    self._last_time, self._last_step = now, step
    if self._num_train_steps:
      eta = (self._num_train_steps - step) / (steps_per_sec + 1e-7)
      self._print(
          f'{100 * step / self._num_train_steps:.1f}% @{step}, '
          f'{steps_per_sec:.2f} steps/s, ETA: {eta / 60:.0f} min')
    return steps_per_sec

  def close(self):
    self.summary_writer.close()
