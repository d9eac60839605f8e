"""A circularly padded convolution input in one CUDA pass (`csrc/wrap.cu`).

`launch` reads an (N, C, H, W) tensor in NHWC memory, and optionally an
(N, 1, H, W) scale, and writes what `layers._padded(x * scale, pads)`
writes for a `layers.Pads` with `wrap`: `top` zero rows above and
`bottom` below, and the width extended by `margin` columns on each side,
column j equal to x[..., (j - margin) mod W]. Each input element is read
once and each output element written once, with no fill before; the
product with the scale is computed in float32 and rounded once to x's
dtype, as PyTorch's multiply rounds. It replaces no TPU kernel (XLA fused
the pad into each convolution's input on the TPU).

Its plain version is the body of `layers._padded`, which decides between
the two. This module takes CUDA tensors only, launches on the current
stream (so a CUDA graph captures it) and raises on a CUDA error; there is
no fallback. The counter `wrap.launches` of `se3ds_torch.tracing` counts
its launches in this process.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from se3ds_torch import tracing
from se3ds_torch.ops import cuda_build

SOURCE = 'wrap.cu'
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VECTOR_BYTES = 16  # the kernel's wide loads and stores

_ARGTYPES = [ctypes.c_int] * 9 + [ctypes.c_void_p] * 4
_FUNCTION = []


def _function():
  if not _FUNCTION:
    fn = cuda_build.load(SOURCE).se3ds_wrap_pad
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    _FUNCTION.append(fn)
  return _FUNCTION[0]


def launch(x: torch.Tensor, top: int, bottom: int, margin: int,
           scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """One wrap pass (CUDA tensors).

  Args:
    x: (N, C, H, W) float32 or bfloat16 CUDA tensor (made channels_last
      memory where it is not).
    top, bottom: zero rows above and below.
    margin: columns added circularly on each side (any size: a margin
      wider than W wraps around more than once).
    scale: None, or an (N, 1, H, W) tensor of x's dtype that x is
      multiplied by first.

  Returns:
    (N, C, top + H + bottom, W + 2 * margin) in x's dtype, channels_last
    memory.
  """
  if x.dtype not in _DTYPES:
    raise TypeError(f'the wrap kernel takes float32 or bfloat16, got '
                    f'{x.dtype}')
  if not x.is_cuda or x.dim() != 4:
    raise ValueError(f'the wrap kernel takes a 4-D CUDA tensor, got '
                     f'{tuple(x.shape)} on {x.device}')
  n, c, h, w = x.shape
  if margin and not w:
    raise ValueError('the wrap kernel cannot wrap an empty width')
  x = x.contiguous(memory_format=torch.channels_last)
  if scale is not None:
    if (scale.shape != (n, 1, h, w) or scale.dtype != x.dtype
        or scale.device != x.device):
      raise ValueError(f'the scale is ({n}, 1, {h}, {w}) {x.dtype} on '
                       f'{x.device}, got {tuple(scale.shape)} {scale.dtype} '
                       f'on {scale.device}')
    scale = scale.contiguous()
  out = torch.empty((n, c, h + top + bottom, w + 2 * margin), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last)
  vector = int(c % (_VECTOR_BYTES // x.element_size()) == 0 and not any(
      t.data_ptr() % _VECTOR_BYTES for t in (x, out)))
  with torch.cuda.device(x.device):
    err = _function()(_DTYPES[x.dtype], vector, n, c, h, w, top, bottom,
                      margin, x.data_ptr(),
                      None if scale is None else scale.data_ptr(),
                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
  if err != 0:
    raise RuntimeError(f'se3ds_wrap_pad failed with CUDA error {err}')
  tracing.counter('wrap.launches')
  return out
