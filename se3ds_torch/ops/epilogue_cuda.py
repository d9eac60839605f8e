"""A convolution's epilogue in one CUDA pass (`csrc/epilogue.cu`).

`launch` reads one or two convolution outputs (or a conv output and a
plain residual) in NHWC memory and writes what the served generator's
chain of elementwise ops after a convolution writes: a partial conv's
renormalisation and update mask, the bias, an eval BatchNorm, a ReLU or
LeakyReLU, a residual add before or after it, and the next layer's
BatchNorm, all in float32 registers with one rounding to the output
dtype. It replaces no TPU kernel (XLA fused these ops on the TPU).

Its plain version is `layers.epilogue_plain`, which composes the layers'
own ops in the same order in float32; `layers.epilogue` decides between
the two. This module takes CUDA tensors only, launches on the current
stream (so a CUDA graph captures it) and raises on a CUDA error; there is
no fallback. The counter `epilogue.launches` of `se3ds_torch.tracing`
counts its launches in this process.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from se3ds_torch import tracing
from se3ds_torch.ops import cuda_build

SOURCE = 'epilogue.cu'
NONE, RELU, LEAKY = 0, 1, 2  # the kernel's activations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VECTOR = 4  # channels a thread loads and stores at once

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_FUNCTION = []


class Operand(NamedTuple):
  """One input of the pass.

  x: (N, C, H, W) a convolution's output (or a plain residual, with no
    other field set).
  window_sum: (N, 1, H, W) the mask's window sums of a partial
    convolution, or None.
  area: the partial convolution's kernel area kh * kw.
  bias: (C,) the convolution's bias, or None.
  norm: (running_mean, running_var, weight, bias), each (C,), of the eval
    BatchNorm that follows, or None.
  """
  x: torch.Tensor
  window_sum: Optional[torch.Tensor] = None
  area: float = 1.0
  bias: Optional[torch.Tensor] = None
  norm: Optional[Sequence[torch.Tensor]] = None


def _function():
  if not _FUNCTION:
    fn = cuda_build.load(SOURCE).se3ds_conv_epilogue
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    _FUNCTION.append(fn)
  return _FUNCTION[0]


def _operand(o: Operand, shape, dtype, device
             ) -> Tuple[list, torch.Tensor, list]:
  """The operand's 7 pointers, its (N, C, H, W) tensor in channels_last
  memory, and the tensors the pointers point into (kept alive)."""
  x = o.x
  if x.shape != shape or x.dtype != dtype or x.device != device:
    raise ValueError(f'every operand is {tuple(shape)} {dtype} on {device}, '
                     f'got {tuple(x.shape)} {x.dtype} on {x.device}')
  x = x.contiguous(memory_format=torch.channels_last)
  ptrs, kept = [x.data_ptr()], [x]
  if o.window_sum is not None:
    ws = o.window_sum
    if ws.shape != (shape[0], 1) + tuple(shape[2:]) or ws.device != device:
      raise ValueError(f'window sums are (N, 1, H, W) on {device}, got '
                       f'{tuple(ws.shape)} on {ws.device}')
    ws = ws.to(dtype).contiguous()
    ptrs.append(ws.data_ptr())
    kept.append(ws)
  else:
    ptrs.append(None)
  vectors = _vectors([o.bias] + list(o.norm or [None] * 4), shape[1], device)
  return ptrs + [_pointer(v) for v in vectors], x, kept + vectors


def _pointer(t: Optional[torch.Tensor]) -> Optional[int]:
  return None if t is None else t.data_ptr()


def _vectors(vectors, channels, device) -> list:
  """Per-channel vectors as the kernel reads them: float32, contiguous
  (None where absent)."""
  out = []
  for v in vectors:
    if v is not None:
      if v.device != device or v.shape != (channels,):
        raise ValueError(f'per-channel vectors are ({channels},) on {device},'
                         f' got {tuple(v.shape)} on {v.device}')
      v = v.to(torch.float32).contiguous()
    out.append(v)
  return out


def launch(a: Operand, b: Optional[Operand] = None, act: int = NONE,
           slope: float = 0.0, residual_after_act: bool = False,
           post_norm: Optional[Sequence[torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """One epilogue pass (CUDA tensors).

  Args:
    a: the pass's first operand, a 4-D float32 or bfloat16 CUDA tensor.
    b: None, or a second operand of a's shape and dtype, added to a
      before the activation, or after it with `residual_after_act`.
    act: NONE, RELU or LEAKY (negative slope `slope`).
    post_norm: (running_mean, running_var, weight, bias) of a BatchNorm
      applied last, or None.

  Returns:
    (out, update_mask): out of a's shape and dtype in channels_last
    memory; update_mask (N, 1, H, W) clamp(window sum, 0, 1) in a's dtype
    where a has a window sum, else None.
  """
  x = a.x
  if x.dtype not in _DTYPES:
    raise TypeError(f'the epilogue kernel takes float32 or bfloat16, got '
                    f'{x.dtype}')
  if not x.is_cuda or x.dim() != 4:
    raise ValueError(f'the epilogue kernel takes a 4-D CUDA tensor, got '
                     f'{tuple(x.shape)} on {x.device}')
  shape, device = x.shape, x.device
  # `kept` holds every tensor the pointers point into until the launch is
  # enqueued: a conversion freed earlier could be reused for `out`.
  ptrs, x, kept = _operand(a, shape, x.dtype, device)
  dense = [x]
  if b is not None:
    b_ptrs, b_x, b_kept = _operand(b, shape, x.dtype, device)
    ptrs += b_ptrs
    dense.append(b_x)
    kept += b_kept
  else:
    ptrs += [None] * 7
  post = _vectors(post_norm or [None] * 4, shape[1], device)
  ptrs += [_pointer(v) for v in post]
  kept += post
  out = torch.empty_like(x, memory_format=torch.channels_last)
  update_mask = None
  if a.window_sum is not None:
    update_mask = torch.empty((shape[0], 1) + tuple(shape[2:]),
                              dtype=x.dtype, device=device)
  ptrs += [out.data_ptr(), _pointer(update_mask)]
  channels = shape[1]
  vector = _VECTOR
  if channels % vector or any(t.data_ptr() % (vector * x.element_size())
                              for t in dense + [out]):
    vector = 1
  pixels = x.numel() // channels if channels else 0
  with torch.cuda.device(device):
    err = _function()(_DTYPES[x.dtype], vector, pixels, channels,
                      (ctypes.c_void_p * len(ptrs))(*ptrs), float(a.area),
                      float(b.area) if b is not None else 1.0, int(act),
                      float(slope), int(residual_after_act),
                      torch.cuda.current_stream().cuda_stream)
  if err != 0:
    raise RuntimeError(f'se3ds_conv_epilogue failed with CUDA error {err}')
  tracing.counter('epilogue.launches')
  return out, update_mask
