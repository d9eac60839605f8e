"""TFRecord framing without TensorFlow (the writer and reader of
`se3ds_tpu.data.tfrecord`, copied): TensorBoard event files are
TFRecord-framed.

Per record: uint64 length (LE) | uint32 masked-crc32c(length) | data |
uint32 masked-crc32c(data).
"""

from __future__ import annotations

import struct
from typing import Iterator



def _build_table():
  """crc32c (Castagnoli) table, polynomial 0x1EDC6F41 (reflected
  0x82F63B78)."""
  table = []
  for i in range(256):
    crc = i
    for _ in range(8):
      crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    table.append(crc)
  return table


_CRC_TABLE = _build_table()


def crc32c(data: bytes, crc: int = 0) -> int:
  crc = crc ^ 0xFFFFFFFF
  for b in data:
    crc = (_CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)) & 0xFFFFFFFF
  return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
  crc = crc32c(data)
  return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


class TFRecordWriter:
  """Writes TFRecord files compatible with tf.io.TFRecordWriter."""

  def __init__(self, path: str):
    self._f = open(path, 'wb')

  def write(self, record: bytes) -> None:
    length = struct.pack('<Q', len(record))
    self._f.write(length)
    self._f.write(struct.pack('<I', masked_crc32c(length)))
    self._f.write(record)
    self._f.write(struct.pack('<I', masked_crc32c(record)))

  def flush(self) -> None:
    self._f.flush()

  def close(self) -> None:
    self._f.close()


def read_records(path: str) -> Iterator[bytes]:
  """Yields the raw record payloads of a TFRecord file, checking both
  checksums of each."""
  with open(path, 'rb') as f:
    while True:
      header = f.read(12)
      if len(header) < 12:
        return
      (length,) = struct.unpack('<Q', header[:8])
      (crc,) = struct.unpack('<I', header[8:12])
      if masked_crc32c(header[:8]) != crc:
        raise IOError(f'corrupted record length crc in {path}')
      data = f.read(length)
      footer = f.read(4)
      if len(data) < length or len(footer) < 4:
        raise IOError(f'truncated record in {path}')
      if masked_crc32c(data) != struct.unpack('<I', footer)[0]:
        raise IOError(f'corrupted record data crc in {path}')
      yield data
