"""Minimal TensorProto codec for the R2R video TFRecords (a copy of
`se3ds_tpu.data.tensorproto`).

The eval dataset stores whole video tensors as serialized TensorProto
messages (`tf.io.serialize_tensor`). This codec reads and writes the
`tensor_content` path (raw little-endian bytes), which is what
tf.io.serialize_tensor produces.

TensorProto fields used: dtype=1 (varint), tensor_shape=2 (TensorShapeProto
{ dim=2 { size=1 } }), tensor_content=4 (bytes).
"""

from __future__ import annotations

import numpy as np

from se3ds_torch.data import example_pb as pb

# tensorflow DataType enum values.
_DT_TO_NP = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    7: object,  # string
    9: np.int64,
    10: np.bool_,
    17: np.uint16,
    22: np.uint32,
    23: np.uint64,
}
_NP_TO_DT = {np.dtype(v): k for k, v in _DT_TO_NP.items() if v is not object}


def encode_tensor(arr: np.ndarray) -> bytes:
  """Serializes an ndarray as TensorProto bytes (tensor_content path)."""
  arr = np.ascontiguousarray(arr)
  out = bytearray()
  pb.write_varint(out, (1 << 3) | 0)  # dtype (field 1, varint)
  pb.write_varint(out, _NP_TO_DT[arr.dtype])
  shape = bytearray()
  for s in arr.shape:
    dim = bytearray()
    pb.write_varint(dim, (1 << 3) | 0)  # Dim.size field 1 varint
    pb.write_varint(dim, s)
    pb.encode_len_delimited(shape, 2, bytes(dim))  # TensorShapeProto.dim
  pb.encode_len_delimited(out, 2, bytes(shape))
  pb.encode_len_delimited(out, 4, arr.astype(arr.dtype.newbyteorder('<'))
                          .tobytes())
  return bytes(out)


def decode_tensor(data: bytes) -> np.ndarray:
  """Parses TensorProto bytes into an ndarray."""
  dtype = None
  shape = []
  content = None
  for field, payload in pb.iter_fields(data, 0, len(data)):
    if field == 1:
      dtype = payload
    elif field == 2:
      for f2, dim in pb.iter_fields(payload, 0, len(payload)):
        if f2 != 2:
          continue
        for f3, v in pb.iter_fields(dim, 0, len(dim)):
          if f3 == 1:
            shape.append(v)
    elif field == 4:
      content = bytes(payload)
  if dtype is None or content is None:
    raise ValueError('TensorProto missing dtype or tensor_content')
  np_dtype = _DT_TO_NP[dtype]
  arr = np.frombuffer(content, dtype=np.dtype(np_dtype).newbyteorder('<'))
  return arr.reshape(shape).astype(np_dtype)
