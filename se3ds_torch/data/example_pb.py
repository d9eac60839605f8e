"""Minimal tf.train.Example wire-format codec, no protobuf dependency (a
copy of `se3ds_tpu.data.example_pb`).

Implements exactly the message subset the SE3DS TFRecord schemas use:

  Example      { Features features = 1; }
  Features     { map<string, Feature> feature = 1; }
  Feature      { oneof { BytesList bytes_list = 1;
                         FloatList float_list = 2;
                         Int64List int64_list = 3; } }
  BytesList    { repeated bytes value = 1; }
  FloatList    { repeated float value = 1 [packed]; }
  Int64List    { repeated int64 value = 1 [packed]; }

The varint and length-delimited writers also serve the event-file logger
(`utils/logger.py`) and the TensorProto codec.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

FeatureValue = Union[List[bytes], List[float], List[int]]


# --- varint ------------------------------------------------------------------

def write_varint(out: bytearray, value: int) -> None:
  while True:
    b = value & 0x7F
    value >>= 7
    if value:
      out.append(b | 0x80)
    else:
      out.append(b)
      return


def read_varint(buf: bytes, pos: int):
  """(value, next position) of the varint at `pos`."""
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _unsigned_to_signed(value: int) -> int:
  """int64 values are stored as two's-complement varints (not zigzag)."""
  if value >= 1 << 63:
    value -= 1 << 64
  return value


# --- encoding ----------------------------------------------------------------

def encode_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
  """Appends field `field` (wire type 2) holding `payload`."""
  write_varint(out, (field << 3) | 2)
  write_varint(out, len(payload))
  out.extend(payload)


def _encode_bytes_list(values: List[bytes]) -> bytes:
  out = bytearray()
  for v in values:
    if isinstance(v, str):
      v = v.encode('utf-8')
    encode_len_delimited(out, 1, bytes(v))
  return bytes(out)


def _encode_float_list(values: List[float]) -> bytes:
  out = bytearray()
  encode_len_delimited(out, 1, struct.pack(f'<{len(values)}f', *values))
  return bytes(out)


def _encode_int64_list(values: List[int]) -> bytes:
  packed = bytearray()
  for v in values:
    write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
  out = bytearray()
  encode_len_delimited(out, 1, bytes(packed))
  return bytes(out)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
  """Encodes a feature dict into tf.train.Example bytes.

  Value types: list of bytes/str -> BytesList; list of float -> FloatList;
  list of int -> Int64List. Scalars are wrapped into single-item lists.
  """
  feats = bytearray()
  for key, value in features.items():
    if not isinstance(value, (list, tuple)):
      value = [value]
    value = list(value)
    if value and isinstance(value[0], (bytes, str)):
      body_field, body = 1, _encode_bytes_list(value)
    elif value and isinstance(value[0], float):
      body_field, body = 2, _encode_float_list(value)
    else:
      body_field, body = 3, _encode_int64_list(value)
    feature = bytearray()
    encode_len_delimited(feature, body_field, body)
    entry = bytearray()
    encode_len_delimited(entry, 1, key.encode('utf-8'))
    encode_len_delimited(entry, 2, bytes(feature))
    encode_len_delimited(feats, 1, bytes(entry))
  example = bytearray()
  encode_len_delimited(example, 1, bytes(feats))
  return bytes(example)


# --- decoding ----------------------------------------------------------------

def iter_fields(buf: bytes, start: int, end: int):
  """Yields (field number, value) of the message in buf[start:end]: an int
  for a varint, bytes for the other wire types."""
  pos = start
  while pos < end:
    tag, pos = read_varint(buf, pos)
    field, wire = tag >> 3, tag & 7
    if wire == 2:
      length, pos = read_varint(buf, pos)
      yield field, buf[pos:pos + length]
      pos += length
    elif wire == 0:
      value, pos = read_varint(buf, pos)
      yield field, value
    elif wire == 5:
      yield field, buf[pos:pos + 4]
      pos += 4
    elif wire == 1:
      yield field, buf[pos:pos + 8]
      pos += 8
    else:
      raise ValueError(f'unsupported wire type {wire}')


def _decode_feature(buf: bytes):
  for field, payload in iter_fields(buf, 0, len(buf)):
    if field == 1:  # BytesList
      return [v for f, v in iter_fields(payload, 0, len(payload)) if f == 1]
    if field == 2:  # FloatList
      values: List[float] = []
      for f, v in iter_fields(payload, 0, len(payload)):
        if f != 1:
          continue
        if not isinstance(v, (bytes, memoryview)):
          raise ValueError('unexpected float encoding')
        values.extend(struct.unpack(f'<{len(v) // 4}f', v))  # packed
      return values
    if field == 3:  # Int64List
      values = []
      for f, v in iter_fields(payload, 0, len(payload)):
        if f != 1:
          continue
        if isinstance(v, (bytes, memoryview)):  # packed varints
          pos = 0
          while pos < len(v):
            val, pos = read_varint(v, pos)
            values.append(_unsigned_to_signed(val))
        else:
          values.append(_unsigned_to_signed(v))
      return values
  return []


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
  """Decodes tf.train.Example bytes into {name: list-of-values}."""
  result: Dict[str, FeatureValue] = {}
  for field, payload in iter_fields(data, 0, len(data)):
    if field != 1:
      continue
    for f2, entry in iter_fields(payload, 0, len(payload)):
      if f2 != 1:
        continue
      key = None
      feature = None
      for f3, v in iter_fields(entry, 0, len(entry)):
        if f3 == 1:
          key = bytes(v).decode('utf-8')
        elif f3 == 2:
          feature = v
      if key is not None and feature is not None:
        result[key] = _decode_feature(feature)
  return result
