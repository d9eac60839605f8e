"""Where the port's entry points run (on the card unless asked otherwise),
and how it divides by a constant on the card."""

from __future__ import annotations

import torch


def resolve(device, owner: str) -> torch.device:
  """`device`, or 'cuda' when it is None; raises where there is no card.

  There is no fallback to the CPU: a caller who wants it passes
  device='cpu'.
  """
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(f'{owner} runs on a CUDA device by default and none '
                         "is available; pass device='cpu' to run on the CPU.")
    device = 'cuda'
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'device={str(device)!r} but CUDA is not available.')
  return device


def divisor(value: float, like: torch.Tensor) -> torch.Tensor:
  """`value` as a 0-dim float tensor on `like`'s device, to divide by.

  PyTorch's CUDA division by a Python scalar multiplies by its
  reciprocal, which can move the quotient by an ULP off the CPU's (and
  the kernels') exact one; division by a 0-dim tensor on the device
  divides. `like`'s float dtype, or float32 for an integer tensor.
  """
  dtype = like.dtype if like.is_floating_point() else torch.float32
  return torch.full((), value, dtype=dtype, device=like.device)
