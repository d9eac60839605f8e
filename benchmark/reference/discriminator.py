"""Plain PyTorch reference of SE3DS's multi-scale PatchGAN discriminator.

A frozen copy of SNMultiScaleDiscriminator as the highres recipe trains
it: `n_dis` spectral-norm PatchGAN discriminators over a 3x3 stride-2
SAME average-pool pyramid; each a plain 4x4 stride-2 conv, then
`n_layers - 1` spectral 4x4 convs (stride 2 but the last) with instance
norm, each followed by LeakyReLU 0.2, and a plain 4x4 'SAME' conv to one
logit channel. Zero padding, no BatchNorm. NHWC at the boundary.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import generator as ref_gen


class PatchDiscriminator(nn.Module):

  def __init__(self, nm, in_features, dis_dims, n_layers, k=4):
    super().__init__()
    self.numerics = nm
    self.n_layers = n_layers
    self.group0_conv = ref_gen.Conv(nm, in_features, dis_dims, k, 2, 'VALID',
                                    fused_pad=k // 2)
    previous = dis_dims
    for i in range(1, n_layers):
      current = min(previous * 2, 512)
      self.add_module(f'group{i}_conv', ref_gen.Conv(
          nm, previous, current, k, 2 if i != n_layers - 1 else 1, 'VALID',
          fused_pad=k // 2, spectral=True))
      self.add_module(f'group{i}_norm', ref_gen.InstanceNorm(current))
      previous = current
    self.final_conv = ref_gen.Conv(nm, previous, 1, k, 1, 'SAME')

  def _group(self, i, x):
    out = getattr(self, f'group{i}_conv')(x)
    if i:
      out = getattr(self, f'group{i}_norm')(out)
    return F.leaky_relu(out, negative_slope=0.2)

  def forward(self, x) -> torch.Tensor:
    for i in range(self.n_layers):
      x = ref_gen.segment(self.numerics, self._group, i, x)
    return self.final_conv(x)


def _avg_pool_3x3_stride2_same(x):
  top, bottom = ref_gen._same_pads(x.shape[-2], 3, 2)
  left, right = ref_gen._same_pads(x.shape[-1], 3, 2)
  pads = (left, right, top, bottom)
  window = lambda t: F.avg_pool2d(F.pad(t, pads), 3, 2, divisor_override=1)
  return window(x) / window(torch.ones_like(x[:1, :1]))


class Discriminator(nn.Module):
  """(N, H, W, C) -> the final logit map of each scale, (N, h, w, 1)."""

  def __init__(self, dis_dims: int, n_dis: int, n_layers: int,
               in_features: int = 4, numerics=None):
    super().__init__()
    nm = numerics or ref_gen.Numerics(train=True)
    self.numerics = nm
    self.n_dis = n_dis
    for d in range(n_dis):
      self.add_module(f'dis{d}', PatchDiscriminator(nm, in_features, dis_dims,
                                                    n_layers))

  def forward(self, x) -> List[torch.Tensor]:
    out = []
    x = x.permute(0, 3, 1, 2)
    for d in range(self.n_dis):
      out.append(getattr(self, f'dis{d}')(x).permute(0, 2, 3, 1))
      if d + 1 < self.n_dis:
        x = _avg_pool_3x3_stride2_same(x)
    return out
