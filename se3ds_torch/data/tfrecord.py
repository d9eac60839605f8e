"""TFRecord container I/O without TensorFlow (a copy of
`se3ds_tpu.data.tfrecord`): the data pipeline's records and TensorBoard
event files are TFRecord-framed.

Per record: uint64 length (LE) | uint32 masked-crc32c(length) | data |
uint32 masked-crc32c(data).

The checksums are computed by the native loader (`data/native_loader.py`)
where it builds, else in Python at ~0.2 s per MiB; the reader checks them
only when asked (`verify_crc=True`), as the JAX package's does.
"""

from __future__ import annotations

import glob
import struct
from typing import Iterator, List

from se3ds_torch.data import native_loader


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


def masked_crc32c(data) -> int:
  """The masked CRC-32C TensorFlow stores, of bytes or a C-contiguous
  numpy array."""
  if native_loader.available():
    crc = native_loader.crc32c(data)
  else:
    crc = crc32c(data.tobytes() if hasattr(data, 'tobytes') else data)
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

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
  """Yields the raw record payloads of a TFRecord file; with `verify_crc`
  checks both checksums of each and raises IOError on a mismatch."""
  with open(path, 'rb') as f:
    while True:
      header = f.read(12)
      if len(header) < 12:
        return
      (length,) = struct.unpack('<Q', header[:8])
      if verify_crc:
        (crc,) = struct.unpack('<I', header[8:12])
        if masked_crc32c(header[:8]) != crc:
          raise IOError(f'corrupted record length crc in {path}')
      data = f.read(length)
      footer = f.read(4)
      if len(data) < length or len(footer) < 4:
        raise IOError(f'truncated record in {path}')
      if verify_crc and masked_crc32c(data) != struct.unpack('<I', footer)[0]:
        raise IOError(f'corrupted record data crc in {path}')
      yield data


def list_files(file_pattern) -> List[str]:
  """Expands glob pattern(s) into a sorted file list; raises
  FileNotFoundError when nothing matches."""
  patterns = (list(file_pattern) if isinstance(file_pattern, (list, tuple))
              else [file_pattern])
  files: List[str] = []
  for pattern in patterns:
    files.extend(glob.glob(pattern))
  if not files:
    raise FileNotFoundError(f'No data files matched {file_pattern}')
  return sorted(files)
