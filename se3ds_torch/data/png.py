"""PNG encode/decode for dataset images and image dumps, without
TensorFlow (a copy of `se3ds_tpu.data.png`).

The SE3DS TFRecords store PNG-encoded RGB images, uint8 masks and uint16
depth maps. PIL provides the fast path where it is installed; a pure
zlib + numpy codec is the fallback and the 16-bit encoder. The pure
decoder's Sub, Average and Paeth filters run per byte in Python (slow on
real, adaptively filtered PNGs): the data pipeline decodes image records
with the native loader (`data/native_loader.py`) where it builds.
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


def decode_png(data: bytes) -> np.ndarray:
  """Decodes PNG bytes to an (H, W) or (H, W, C) uint8/uint16 array."""
  if _HAS_PIL:
    arr = np.asarray(_PILImage.open(io.BytesIO(data)))
    if arr.dtype == np.int32:  # PIL's 'I' mode for 16-bit
      arr = arr.astype(np.uint16)
    return arr
  return _decode_png_pure(data)


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


def _paeth(a: int, b: int, c: int) -> int:
  p = a + b - c
  pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
  if pa <= pb and pa <= pc:
    return a
  return b if pb <= pc else c


def _decode_png_pure(data: bytes) -> np.ndarray:
  if data[:8] != _PNG_SIG:
    raise ValueError('not a PNG')
  pos = 8
  idat = bytearray()
  ihdr = None
  while pos < len(data):
    (length,) = struct.unpack('>I', data[pos:pos + 4])
    tag = data[pos + 4:pos + 8]
    payload = data[pos + 8:pos + 8 + length]
    pos += 12 + length
    if tag == b'IHDR':
      ihdr = struct.unpack('>IIBBBBB', payload)
    elif tag == b'IDAT':
      idat.extend(payload)
    elif tag == b'IEND':
      break
  w, h, bit_depth, color_type, _, _, interlace = ihdr
  if interlace != 0:
    raise ValueError('interlaced PNG unsupported')
  channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
  bpp = channels * (bit_depth // 8)
  stride = w * bpp
  raw = zlib.decompress(bytes(idat))
  out = np.zeros((h, stride), np.uint8)
  prev = np.zeros((stride,), np.uint8)
  for y in range(h):
    f = raw[y * (stride + 1)]
    line = np.frombuffer(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)],
                         np.uint8).copy()
    if f == 2:  # up
      line = line + prev
    elif f in (1, 3, 4):  # sub / average / paeth: a sequential scan
      cur = [0] * stride
      up = prev.tolist()
      for x, byte in enumerate(line.tolist()):
        a = cur[x - bpp] if x >= bpp else 0
        c = up[x - bpp] if x >= bpp else 0
        if f == 1:
          pred = a
        elif f == 3:
          pred = (a + up[x]) // 2
        else:
          pred = _paeth(a, up[x], c)
        cur[x] = (byte + pred) & 0xFF
      line = np.asarray(cur, np.uint8)
    elif f != 0:
      raise ValueError(f'unsupported filter {f}')
    out[y] = line
    prev = line
  if bit_depth == 16:
    arr = out.reshape(h, w, channels, 2)
    arr = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
  else:
    arr = out.reshape(h, w, channels)
  if channels == 1:
    arr = arr[..., 0]
  return arr
