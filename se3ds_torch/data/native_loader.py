"""ctypes bindings for the port's native C++ data loader
(`se3ds_torch/csrc/dataloader.cc`, a copy of the JAX package's).

TFRecord iteration, the records' CRC-32C, and one-call decode of an R2R
image-pair Example into preallocated numpy buffers, with the interpreter
lock released during each call. The library is built at first use with
g++ (and zlib) into `build/se3ds_torch/`, under a name that carries a
hash of the source and the flags. Where it cannot be built (no g++, no
zlib headers), `available()` is False and the data pipeline decodes and
checksums in Python; this is a host decoder, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from se3ds_torch.ops import cuda_build

SOURCE = cuda_build.CSRC_DIR / 'dataloader.cc'
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

log = logging.getLogger('se3ds_torch')

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def library_path() -> Path:
  """Where the library built from SOURCE lives."""
  digest = hashlib.sha1(SOURCE.read_bytes())
  digest.update(' '.join(GXX_FLAGS).encode())
  return cuda_build.BUILD_DIR / (
      f'libse3ds_dataloader_{digest.hexdigest()[:16]}.so')


def _build() -> Optional[Path]:
  """Builds the library unless it is there; None (and a warning) where it
  cannot be built."""
  out = library_path()
  if out.exists():
    return out
  gxx = shutil.which('g++')
  if gxx is None:
    log.warning('native data loader: no g++; decoding in Python')
    return None
  out.parent.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
  proc = subprocess.run([gxx, *GXX_FLAGS, '-o', str(tmp), str(SOURCE),
                         '-lz'], capture_output=True, text=True,
                        timeout=300, check=False)
  if proc.returncode != 0:
    log.warning('native data loader did not build; decoding in Python:\n%s',
                proc.stderr)
    return None
  os.replace(tmp, out)
  return out


def get_lib() -> Optional[ctypes.CDLL]:
  """Builds (once) and loads the library; None if it cannot be built."""
  global _LIB, _TRIED
  with _LOCK:
    if _TRIED:
      return _LIB
    _TRIED = True
    path = _build()
    if path is None:
      return None
    lib = ctypes.CDLL(str(path))
    lib.se3ds_tfr_open.restype = ctypes.c_void_p
    lib.se3ds_tfr_open.argtypes = [ctypes.c_char_p]
    lib.se3ds_tfr_next.restype = ctypes.c_longlong
    lib.se3ds_tfr_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int]
    lib.se3ds_tfr_close.restype = None
    lib.se3ds_tfr_close.argtypes = [ctypes.c_void_p]
    lib.se3ds_crc32c.restype = ctypes.c_uint32
    lib.se3ds_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.se3ds_decode_image_example.restype = ctypes.c_int
    lib.se3ds_decode_image_example.argtypes = (
        [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint32]
        + [ctypes.c_void_p] * 8
        + [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_longlong),
           ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)])
    _LIB = lib
    return _LIB


def available() -> bool:
  return get_lib() is not None


def crc32c(data) -> int:
  """CRC-32C (Castagnoli) of `data` (bytes, or a C-contiguous numpy array
  read in place), as `tfrecord.crc32c` computes it."""
  lib = get_lib()
  if lib is None:
    raise RuntimeError('the native data loader is not available')
  if isinstance(data, np.ndarray):
    if not data.flags.c_contiguous:
      raise ValueError('crc32c needs a C-contiguous array')
    return lib.se3ds_crc32c(data.ctypes.data, data.nbytes)
  return lib.se3ds_crc32c(data, len(data))


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
  """Native TFRecord payload iterator (the same records as
  `tfrecord.read_records`)."""
  lib = get_lib()
  if lib is None:
    raise RuntimeError('the native data loader is not available')
  handle = lib.se3ds_tfr_open(path.encode())
  if not handle:
    raise IOError(f'cannot open {path}')
  try:
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    while True:
      n = lib.se3ds_tfr_next(handle, ctypes.byref(ptr),
                             1 if verify_crc else 0)
      if n == 0:
        return
      if n < 0:
        raise IOError(f'corrupt TFRecord in {path} (code {n})')
      yield ctypes.string_at(ptr, n)
  finally:
    lib.se3ds_tfr_close(handle)


def decode_image_example(record: bytes,
                         height: int) -> Dict[str, np.ndarray]:
  """Decodes an image-pair Example with one native call, into the feature
  dict of `datasets._decode_image_example` (the same values)."""
  lib = get_lib()
  if lib is None:
    raise RuntimeError('the native data loader is not available')
  h, w = height, height * 2
  image = np.empty((h, w, 3), np.uint8)
  proj = np.empty((h, w, 3), np.uint8)
  depth = np.empty((h, w), np.uint16)
  proj_depth = np.empty((h, w), np.uint16)
  proj_mask = np.empty((h, w), np.uint8)
  blurred = np.empty((h, w), np.uint8)
  seg = np.empty((h, w), np.uint8)
  visible = np.zeros((h, w), np.uint8)
  depth_scale = ctypes.c_float()
  dataset_type = ctypes.c_longlong()
  bbox = (ctypes.c_float * 4)()
  has_visible = ctypes.c_int()
  buffers = (image, proj, depth, proj_depth, proj_mask, blurred, seg,
             visible)
  rc = lib.se3ds_decode_image_example(
      record, len(record), h, w,
      *(b.ctypes.data_as(ctypes.c_void_p) for b in buffers),
      ctypes.byref(depth_scale), ctypes.byref(dataset_type), bbox,
      ctypes.byref(has_visible))
  if rc != 0:
    raise ValueError(f'native decode failed with code {rc}')

  out = {
      'dataset_type': int(dataset_type.value),
      'depth_scale': float(depth_scale.value),
      'bbox': np.asarray(bbox[:], np.float32),
      'image': image.astype(np.float32) / 255.0,
      'proj_image': proj.astype(np.float32) / 255.0,
      'proj_depth': proj_depth.astype(np.float32) / 65535.0,
      'proj_mask': np.clip(proj_mask, 0, 1).astype(np.float32),
      'blurred_mask': np.clip(blurred, 0, 1).astype(np.float32)[..., None],
      'segmentation': seg.astype(np.int32),
      'depth': depth.astype(np.float32) / 65535.0,
      'filename': b'',
      'scan_id': b'',
  }
  out['segmentation_valid'] = np.float32(np.any(out['segmentation'] != 0))
  if out['dataset_type'] == 2 and has_visible.value:  # RE10K
    vis = np.clip(visible, 0, 1).astype(np.float32)[..., None]
    out['visible_mask'] = vis
    out['blurred_mask'] = 1.0 - vis
  else:
    out['visible_mask'] = np.zeros((h, w, 1), np.float32)
  return out
