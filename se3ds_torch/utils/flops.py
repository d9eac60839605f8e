"""FLOP counts of a call, by its matmuls and convolutions (port of
`se3ds_tpu.utils.flops`).

`count_flops(fn, *args, **kwargs)` runs `fn` under PyTorch's
`FlopCounterMode` and returns 2 * MACs of every matrix product and
convolution it dispatches, forward and backward (a rematerialised
segment's recompute included, as it runs). Elementwise work is not
counted, as in the JAX count, which walks the jaxpr.

Convolutions are counted as JAX lowers them to `conv_general_dilated`,
over the positions of each one's output:
* a forward convolution: over its output, transposed ones included (JAX
  dilates a transposed conv's input with zeros and counts them;
  `FlopCounterMode`'s own rule counts it over its input);
* the input gradient: over the input (JAX dilates the output gradient of
  a strided conv; PyTorch's rule counts over the output gradient);
* the weight gradient: over the output gradient, the same count as the
  forward.
With one group, all three are 2 * batch * positions * kernel elements.

`fn` may take tensors on the `meta` device: the count needs the shapes
alone, so a full-size step is counted without memory or compute.
"""

from __future__ import annotations

import math

from torch.utils import flop_counter

aten = flop_counter.aten


def _conv_flops(x_shape, w_shape, _bias, _stride, _padding, _dilation,
                _transposed, *args, out_shape=None, **kwargs) -> int:
  del args, kwargs
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


_JAX_RULES = {aten.convolution: _conv_flops,
              aten._convolution: _conv_flops,
              aten.convolution_backward: _conv_backward_flops}


def count_flops(fn, *args, **kwargs) -> int:
  """Matmul + conv FLOPs (2 * MACs) of one `fn(*args, **kwargs)` call."""
  with flop_counter.FlopCounterMode(display=False,
                                    custom_mapping=_JAX_RULES) as counter:
    fn(*args, **kwargs)
  return counter.get_total_flops()
