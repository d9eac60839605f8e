"""TensorFlow checkpoint bundles, read and written without TensorFlow.

A `tf.train.Checkpoint` (or `SaveV2`) bundle at `prefix` is two kinds of
file (tensorflow/core/util/tensor_bundle):

* `{prefix}.index`: a LevelDB-format table, uncompressed, sorted by key.
  Each data block holds prefix-compressed entries (varint shared length,
  varint unshared length, varint value length, the key's unshared bytes,
  the value), then its restart offsets (uint32 each) and their count; a
  5-byte trailer follows each block (compression type, masked CRC-32C of
  the block and that byte) and is not counted in its handle's size. The
  index block maps a key at or above each data block's last key to the
  block's handle (varint offset, varint size). The 48-byte footer holds
  the metaindex and index handles, zero padding to 40 bytes, then the
  magic 0xdb4775248b80fb57 (little-endian). The value under key "" is a
  `BundleHeaderProto` (num_shards 1, endianness 2, version 3); every other
  value is a `BundleEntryProto` (dtype 1, shape 2, shard_id 3, offset 4,
  size 5, crc32c 6 as fixed32, slices 7).
* `{prefix}.data-{shard:05d}-of-{num_shards:05d}`: the tensors' raw
  little-endian bytes, at each entry's offset.

`BundleReader` is what `tf.train.load_checkpoint` gives the JAX package's
converter: the key -> shape and key -> dtype maps, and one tensor at a
time, read from the memory-mapped data file and checked against the
entry's masked CRC-32C as TensorFlow's reader checks it.
`latest_checkpoint` resolves a directory as `tf.train.latest_checkpoint`
does. `write_bundle` is the format's inverse, for tests and fixtures.
"""

from __future__ import annotations

import codecs
import os
import re
import struct
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

from se3ds_torch.data import example_pb
from se3ds_torch.data import tfrecord

MAGIC = 0xdb4775248b80fb57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
BLOCK_SIZE = 262144  # TensorFlow's table::Options::block_size
RESTART_INTERVAL = 16  # table::Options::block_restart_interval

# tensorflow/core/framework/types.proto DataType values the reader decodes.
DTYPES = {1: np.dtype('<f4'), 2: np.dtype('<f8'), 3: np.dtype('<i4'),
          4: np.dtype('u1'), 9: np.dtype('<i8'), 10: np.dtype('bool'),
          19: np.dtype('<f2')}
DT_STRING = 7
_DATATYPE_NAMES = {5: 'DT_INT16', 6: 'DT_INT8', 7: 'DT_STRING',
                   8: 'DT_COMPLEX64', 14: 'DT_BFLOAT16', 17: 'DT_UINT16',
                   18: 'DT_COMPLEX128', 22: 'DT_UINT32', 23: 'DT_UINT64'}


class Entry(NamedTuple):
  """A decoded `BundleEntryProto`."""
  dtype: int
  shape: Tuple[int, ...]
  shard_id: int
  offset: int
  size: int
  crc32c: int
  sliced: bool


def data_file(prefix: str, shard: int, num_shards: int) -> str:
  return f'{prefix}.data-{shard:05d}-of-{num_shards:05d}'


# --- reading -----------------------------------------------------------------


def _handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
  """(offset, size, next position) of the BlockHandle at `pos`."""
  offset, pos = example_pb.read_varint(buf, pos)
  size, pos = example_pb.read_varint(buf, pos)
  return offset, size, pos


def _read_block(f, offset: int, size: int, path: str) -> bytes:
  f.seek(offset)
  raw = f.read(size + BLOCK_TRAILER_BYTES)
  if len(raw) != size + BLOCK_TRAILER_BYTES:
    raise ValueError(f'{path}: truncated block at {offset}')
  if raw[size] != 0:
    raise ValueError(f'{path}: block at {offset} is compressed (type '
                     f'{raw[size]}); bundles are written uncompressed')
  (crc,) = struct.unpack_from('<I', raw, size + 1)
  if tfrecord.masked_crc32c(raw[:size + 1]) != crc:
    raise ValueError(f'{path}: checksum mismatch in the block at {offset}')
  return raw[:size]


def _block_entries(block: bytes):
  """Yields (key, value) of a table block, undoing the prefix
  compression."""
  (num_restarts,) = struct.unpack_from('<I', block, len(block) - 4)
  end = len(block) - 4 - 4 * num_restarts
  pos, key = 0, b''
  while pos < end:
    shared, pos = example_pb.read_varint(block, pos)
    unshared, pos = example_pb.read_varint(block, pos)
    value_len, pos = example_pb.read_varint(block, pos)
    key = key[:shared] + block[pos:pos + unshared]
    pos += unshared
    yield key, block[pos:pos + value_len]
    pos += value_len


def _decode_entry(value: bytes) -> Entry:
  fields = dict(dtype=0, shape=(), shard_id=0, offset=0, size=0, crc32c=0,
                sliced=False)
  for field, v in example_pb.iter_fields(value, 0, len(value)):
    if field == 1:
      fields['dtype'] = v
    elif field == 2:  # TensorShapeProto: repeated Dim dim = 2 {size = 1}
      dims = []
      for f, dim in example_pb.iter_fields(v, 0, len(v)):
        if f == 2:
          size = 0
          for g, s in example_pb.iter_fields(dim, 0, len(dim)):
            if g == 1:
              size = example_pb._unsigned_to_signed(s)
          dims.append(size)
        elif f == 3 and dim:
          raise ValueError('a bundle entry of unknown rank')
      fields['shape'] = tuple(dims)
    elif field == 3:
      fields['shard_id'] = v
    elif field == 4:
      fields['offset'] = v
    elif field == 5:
      fields['size'] = v
    elif field == 6:
      (fields['crc32c'],) = struct.unpack('<I', v)
    elif field == 7:
      fields['sliced'] = True
  return Entry(**fields)


def _datatype_name(dtype: int) -> str:
  return _DATATYPE_NAMES.get(dtype, f'DataType {dtype}')


class BundleReader:
  """Reads a checkpoint bundle at `prefix` (`tf.train.load_checkpoint`'s
  reader, without TensorFlow)."""

  def __init__(self, prefix: str):
    self.prefix = prefix
    path = prefix + '.index'
    with open(path, 'rb') as f:
      f.seek(0, os.SEEK_END)
      if f.tell() < FOOTER_BYTES:
        raise ValueError(f'{path} is too short for a table')
      f.seek(-FOOTER_BYTES, os.SEEK_END)
      footer = f.read(FOOTER_BYTES)
      if struct.unpack_from('<Q', footer, 40)[0] != MAGIC:
        raise ValueError(f'{path} is not a checkpoint index (bad magic)')
      _, _, pos = _handle(footer)
      index_offset, index_size, _ = _handle(footer, pos)
      index = _read_block(f, index_offset, index_size, path)
      entries = {}
      for _, handle in _block_entries(index):
        offset, size, _ = _handle(handle)
        for key, value in _block_entries(_read_block(f, offset, size, path)):
          entries[key.decode()] = value
    if '' not in entries:
      raise ValueError(f'{path} has no bundle header')
    header = entries.pop('')
    header = dict(example_pb.iter_fields(header, 0, len(header)))
    self.num_shards = header.get(1, 0)
    if header.get(2, 0) != 0:
      raise ValueError(f'{path}: a big-endian bundle')
    self._entries = {k: _decode_entry(v) for k, v in entries.items()}

  def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
    return {k: list(e.shape) for k, e in self._entries.items()}

  def get_variable_to_dtype_map(self) -> Dict[str, object]:
    """Key -> numpy dtype (object for DT_STRING, as TensorFlow's
    `as_numpy_dtype`); another DataType is given by its name."""
    return {k: (DTYPES.get(e.dtype) if e.dtype in DTYPES
                else np.dtype(object) if e.dtype == DT_STRING
                else _datatype_name(e.dtype))
            for k, e in self._entries.items()}

  def get_tensor(self, name: str) -> np.ndarray:
    """The tensor under `name`, copied out of the data file once its
    bytes match the entry's checksum. Each tensor's bytes are mapped on
    their own and unmapped once copied, so the mapped pages of a large
    bundle do not add up in the process's memory.

    Raises:
      KeyError: no such key.
      ValueError: a DT_STRING or other undecoded DataType, a sliced entry,
        a size that does not match the shape, or a checksum mismatch.
    """
    if name not in self._entries:
      raise KeyError(f'{name!r} is not in the checkpoint {self.prefix}')
    entry = self._entries[name]
    if entry.sliced:
      raise ValueError(f'{name!r} is saved in slices, which this reader '
                       'does not assemble')
    if entry.dtype not in DTYPES:
      raise ValueError(f'{name!r} is a {_datatype_name(entry.dtype)} '
                       'tensor, which this reader does not decode')
    dtype = DTYPES[entry.dtype]
    count = int(np.prod(entry.shape, dtype=np.int64))
    if entry.size != count * dtype.itemsize:
      raise ValueError(f'{name!r}: {entry.size} bytes for shape '
                       f'{entry.shape} of {dtype}')
    path = data_file(self.prefix, entry.shard_id, self.num_shards)
    raw = np.zeros(0, np.uint8)
    if entry.size:
      if os.path.getsize(path) < entry.offset + entry.size:
        raise ValueError(f'{name!r}: {path} ends inside the tensor')
      raw = np.memmap(path, np.uint8, 'r', entry.offset, (entry.size,))
    if tfrecord.masked_crc32c(raw) != entry.crc32c:
      raise ValueError(f'{name!r}: checksum mismatch in {path}')
    return np.array(raw.view(dtype).reshape(entry.shape),
                    dtype.newbyteorder('='))


def latest_checkpoint(directory: str) -> Optional[str]:
  """The prefix named by `model_checkpoint_path` in `directory`'s
  `checkpoint` state file (joined to `directory` when relative), or None
  without a state file or when that bundle's index is missing."""
  state = os.path.join(directory, 'checkpoint')
  if not os.path.exists(state):
    return None
  with open(state, encoding='utf-8') as f:
    match = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"',
                      f.read(), re.MULTILINE)
  if match is None:
    return None
  path = codecs.escape_decode(match.group(1))[0].decode('utf-8')
  if not os.path.isabs(path):
    path = os.path.join(directory, path)
  return path if os.path.exists(path + '.index') else None


# --- writing -----------------------------------------------------------------


class _TableBlock:
  """Prefix-compressed table block entries with restarts."""

  def __init__(self, restart_interval: int):
    self.restart_interval = restart_interval
    self.buf = bytearray()
    self.restarts = [0]
    self.count = 0
    self.last_key = b''

  def add(self, key: bytes, value: bytes) -> None:
    shared = 0
    if self.count < self.restart_interval:
      limit = min(len(key), len(self.last_key))
      while shared < limit and key[shared] == self.last_key[shared]:
        shared += 1
    else:
      self.restarts.append(len(self.buf))
      self.count = 0
    for v in (shared, len(key) - shared, len(value)):
      example_pb.write_varint(self.buf, v)
    self.buf += key[shared:]
    self.buf += value
    self.last_key = key
    self.count += 1

  def size(self) -> int:
    return len(self.buf) + 4 * len(self.restarts) + 4

  def finish(self) -> bytes:
    return bytes(self.buf) + struct.pack(
        f'<{len(self.restarts) + 1}I', *self.restarts, len(self.restarts))


def _write_block(f, block: bytes) -> bytes:
  """Writes a block and its trailer; returns its encoded handle."""
  handle = bytearray()
  example_pb.write_varint(handle, f.tell())
  example_pb.write_varint(handle, len(block))
  f.write(block)
  f.write(b'\0' + struct.pack('<I', tfrecord.masked_crc32c(block + b'\0')))
  return bytes(handle)


def _encode_entry(dtype: int, shape, offset: int, size: int, crc: int
                  ) -> bytes:
  out = bytearray()
  example_pb.write_varint(out, 1 << 3)
  example_pb.write_varint(out, dtype)
  dims = bytearray()
  for d in shape:
    dim = bytearray()
    if d:
      example_pb.write_varint(dim, 1 << 3)
      example_pb.write_varint(dim, int(d))
    example_pb.encode_len_delimited(dims, 2, bytes(dim))
  example_pb.encode_len_delimited(out, 2, bytes(dims))
  for field, value in ((4, offset), (5, size)):
    if value:
      example_pb.write_varint(out, field << 3)
      example_pb.write_varint(out, value)
  out += bytes([6 << 3 | 5]) + struct.pack('<I', crc)
  return bytes(out)


def write_bundle(prefix: str, tensors: Mapping[str, np.ndarray]) -> None:
  """Writes `tensors` ({key: numpy array} of the dtypes the reader
  decodes) as a one-shard bundle at `prefix`, which TensorFlow's reader
  reads back; data blocks close at BLOCK_SIZE bytes, as TensorFlow's
  writer closes them."""
  by_dtype = {v: k for k, v in DTYPES.items()}
  entries = {}
  os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
  with open(data_file(prefix, 0, 1), 'wb') as f:
    for name, value in tensors.items():
      array = np.asarray(value)
      dtype = array.dtype.newbyteorder('<')
      if dtype not in by_dtype:
        raise ValueError(f'{name!r}: write_bundle does not write {dtype}')
      array = array.astype(dtype, order='C', copy=False)
      raw = array.reshape(-1).view(np.uint8)
      entries[name.encode()] = _encode_entry(
          by_dtype[dtype], array.shape, f.tell(), raw.size,
          tfrecord.masked_crc32c(raw))
      f.write(memoryview(raw))
  header = bytearray(b'\x08\x01')  # num_shards 1, little-endian (0)
  example_pb.encode_len_delimited(header, 3, b'\x08\x01')  # producer 1
  with open(prefix + '.index', 'wb') as f:
    index = _TableBlock(1)
    block = _TableBlock(RESTART_INTERVAL)
    for key, value in [(b'', bytes(header))] + sorted(entries.items()):
      block.add(key, value)
      if block.size() >= BLOCK_SIZE:
        index.add(block.last_key, _write_block(f, block.finish()))
        block = _TableBlock(RESTART_INTERVAL)
    if block.count:
      index.add(block.last_key, _write_block(f, block.finish()))
    metaindex = _write_block(f, _TableBlock(1).finish())
    index_handle = _write_block(f, index.finish())
    footer = (metaindex + index_handle).ljust(40, b'\0')
    f.write(footer + struct.pack('<Q', MAGIC))
