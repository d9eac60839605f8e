"""Matmul and convolution FLOPs of the reference model, on the meta device.

The count is taken on the benchmark's own copy of the model, so a share
of a peak reads the same work whatever implements it. Convolutions are
counted as the JAX package counts them, over the positions of each one's
output (a transposed one too), 2 * MACs; elementwise work is not counted.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils import flop_counter

from benchmark.reference import generator as ref_gen

aten = flop_counter.aten


def _conv_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
  del x_shape, args, kwargs
  return 2 * out_shape[0] * math.prod(out_shape[2:]) * math.prod(w_shape)


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, _transposed, _output_padding,
                         _groups, output_mask, out_shape=None,
                         **kwargs) -> int:
  del out_shape, kwargs
  kernel = math.prod(w_shape)
  flops = 0
  if output_mask[0]:
    flops += 2 * x_shape[0] * math.prod(x_shape[2:]) * kernel
  if output_mask[1]:
    flops += 2 * grad_out_shape[0] * math.prod(grad_out_shape[2:]) * kernel
  return flops


RULES = {aten.convolution: _conv_flops, aten._convolution: _conv_flops,
         aten.convolution_backward: _conv_backward_flops}


def count(fn, *args, **kwargs) -> int:
  with flop_counter.FlopCounterMode(display=False,
                                    custom_mapping=RULES) as counter:
    fn(*args, **kwargs)
  return counter.get_total_flops()


@functools.lru_cache(maxsize=8)
def served_pano(gen_dims: int, resnet_version: str, height: int,
                use_blurred_mask: bool = True) -> int:
  """FLOPs of one served panorama (batch 1, height x 2 height)."""
  with torch.device('meta'):
    model = ref_gen.Generator(gen_dims, resnet_version, use_blurred_mask)
    shape = (1, height, 2 * height)
    cond = {'proj_image': torch.empty(shape + (3,)),
            'proj_depth': torch.empty(shape + (1,)),
            'proj_mask': torch.empty(shape + (1,)),
            'blurred_mask': torch.empty(shape + (1,))}
  with torch.no_grad():
    return count(model, cond)
