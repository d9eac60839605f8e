"""PNG encoding without TensorFlow (the encoder of `se3ds_tpu.data.png`,
copied; the port has no data pipeline yet, so nothing here decodes).

PIL provides the fast path for uint8 images; a pure zlib codec is the
fallback and the 16-bit path.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

try:
  from PIL import Image as _PILImage
  _HAS_PIL = True
except ImportError:  # pragma: no cover
  _HAS_PIL = False

_PNG_SIG = b'\x89PNG\r\n\x1a\n'


def encode_png(arr: np.ndarray) -> bytes:
  """Encodes a uint8 (H,W[,C]) or uint16 (H,W) array to PNG bytes."""
  if _HAS_PIL and arr.dtype == np.uint8:
    buf = io.BytesIO()
    _PILImage.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()
  return _encode_png_pure(arr)


def _chunk(tag: bytes, payload: bytes) -> bytes:
  return (struct.pack('>I', len(payload)) + tag + payload
          + struct.pack('>I', zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _encode_png_pure(arr: np.ndarray) -> bytes:
  if arr.ndim == 2:
    arr = arr[..., None]
  h, w, c = arr.shape
  if arr.dtype == np.uint8:
    bit_depth = 8
  elif arr.dtype == np.uint16:
    bit_depth = 16
  else:
    raise ValueError(f'unsupported dtype {arr.dtype}')
  color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
  ihdr = struct.pack('>IIBBBBB', w, h, bit_depth, color_type, 0, 0, 0)
  if bit_depth == 16:
    raw = arr.astype('>u2').tobytes()
    stride = w * c * 2
  else:
    raw = arr.tobytes()
    stride = w * c
  lines = bytearray()
  for y in range(h):
    lines.append(0)  # filter: none
    lines.extend(raw[y * stride:(y + 1) * stride])
  idat = zlib.compress(bytes(lines), 6)
  return (_PNG_SIG + _chunk(b'IHDR', ihdr) + _chunk(b'IDAT', idat)
          + _chunk(b'IEND', b''))
