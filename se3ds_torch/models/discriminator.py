"""PatchGAN discriminators (port of `se3ds_tpu.models.discriminator`).

They take NHWC images, run NCHW inside and return NHWC maps (views).
Train and eval mode differ only in the spectral convs: in training each
call stores its power-iteration state `u`, at eval it does not. There is
no BatchNorm and no circular padding (`circular_pad=False` everywhere in
the reference's configs).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from se3ds_torch.models import layers


class SNPatchDiscriminator(nn.Module):
  """Spectral-normalised PatchGAN discriminator on NCHW input.

  Returns every intermediate feature map, NCHW; the last is the
  1-channel real/fake logit map.
  """

  def __init__(self, in_features: int = 4, kernel_size: int = 4,
               dis_dims: int = 64, n_layers: int = 4,
               circular_pad: bool = False):
    super().__init__()
    k = kernel_size
    self.n_layers = n_layers
    self.group0_conv = layers.Conv2D(in_features, dis_dims, k, 2, 'VALID',
                                     fused_pad=k // 2, circular=circular_pad)
    previous_dim = dis_dims
    for i in range(1, n_layers):
      current_dim = min(previous_dim * 2, 512)
      strides = 2 if i != n_layers - 1 else 1
      self.add_module(f'group{i}_conv', layers.SpectralConv(
          previous_dim, current_dim, k, strides, 'VALID', fused_pad=k // 2,
          circular=circular_pad, fold=False))
      self.add_module(f'group{i}_norm', layers.InstanceNorm(current_dim))
      previous_dim = current_dim
    # 'SAME' at k=4, stride 1: one row/column before, two after.
    self.final_conv = layers.Conv2D(previous_dim, 1, k, 1, 'SAME')

  def _group(self, i: int, x: torch.Tensor) -> torch.Tensor:
    out = getattr(self, f'group{i}_conv')(x)
    if i:
      out = getattr(self, f'group{i}_norm')(out)
    return F.leaky_relu(out, negative_slope=0.2)

  def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
    results = []
    out = x
    for i in range(self.n_layers):
      out = layers.remat(self._group, i, out,
                         state_of=(getattr(self, f'group{i}_conv'),))
      results.append(out)
    results.append(self.final_conv(out))
    return results


class SNMultiScaleDiscriminator(nn.Module):
  """Multi-scale PatchGAN: `n_dis` discriminators over an average-pool
  pyramid (TF's 3x3 stride-2 SAME pool)."""

  def __init__(self, in_features: int = 4, n_dis: int = 2,
               kernel_size: int = 4, dis_dims: int = 96, n_layers: int = 5,
               circular_pad: bool = False):
    super().__init__()
    self.n_dis = n_dis
    for d in range(n_dis):
      self.add_module(f'dis{d}', SNPatchDiscriminator(
          in_features, kernel_size, dis_dims, n_layers, circular_pad))

  def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
    """x: (N, H, W, C). Returns, per discriminator, its maps (N, h, w, c)."""
    result = []
    prev = x.permute(0, 3, 1, 2).contiguous()  # see ResNetGenerator.forward
    for d in range(self.n_dis):
      maps = getattr(self, f'dis{d}')(prev)
      result.append([m.permute(0, 2, 3, 1) for m in maps])
      if d + 1 < self.n_dis:
        prev = layers.avg_pool_3x3_stride2_same(prev)
    return result
