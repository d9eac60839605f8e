"""Where the port's entry points run: on the card unless asked otherwise."""

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
