"""Generator and discriminator building blocks (port of
`se3ds_tpu.models.layers`).

All tensors here have the NCHW shape; `generator.ResNetGenerator` and
the discriminators permute from and to the NHWC layout of the public API.
Their memory order is the input's, which every layer keeps:
channels_last (NHWC memory) when serving, where the permuted input is a
channels_last view and `SE3DSModel` stores the kernels channels_last
too, so cuDNN runs its NHWC kernels without transposing their operands;
contiguous NCHW in training, which makes its inputs contiguous. Each
convolution counts itself in the counters `generator.convs` and
`generator.nchw_convs` (`se3ds_torch.tracing`; the discriminator's
convolutions, which run in training only, count too): the second where
its input or its kernel is not in channels_last memory.

Module and attribute names copy the Flax names (`conv1`, `act1_bn`,
`block{i}`, `main_convt`, ...), so the state_dict keys of
`folding.torch_state_dict_from_flax` follow the Flax variable paths.

Train and eval mode is the module's `self.training`, the Flax `train`
argument:

* Circular (width-wrap) padding is the eval behaviour of the reference;
  in training every pad is zeros, masks included. Each conv pads its own
  input here, which equals the JAX package's wrap-once chains (circular
  convolution commutes with the wrap).
* A `SpectralConv` is folded (`fold=True`: the serving form, the kernel
  divided by sigma at load) or unfolded: a power-iteration state `u`,
  one iteration per call with a gradient through sigma, `u` stored only
  in training. An unfolded `PartialConv` with `spectral_norm` keeps its
  inert `u` up to date in training and convolves with the raw kernel.
* `SyncBatchNorm` normalises with the batch statistics in training and
  updates its running statistics by Flax's rule; under a
  `torch.distributed` process group the statistics are those of the
  global batch. At eval it normalises by Flax's formula with the running
  statistics.

What follows a convolution (a partial convolution's renormalisation, the
bias, a BatchNorm, the activation, a residual add, the next layer's
leading BatchNorm) is one call of `epilogue` in every block, in training
and at eval alike: each convolution module's `convolve` returns its
output without the bias, and its `forward` is `convolve` and `epilogue`.
Served (eval, nothing for autograd to record, on the card) that call is
one launch of a CUDA kernel that reads each convolution output once and
rounds once, counted in `epilogue.launches`, and the convolution outputs
it reads in `generator.fused_convs`; elsewhere it is the layers' own ops
computed in float32 (`epilogue_plain`), the same ops as each layer's
when the tensors are float32.

How a convolution pads its input is decided in one place, `conv_pads`
(its fused pad, TF's 'SAME' pads, the circular width at eval), for the
whole image and for a rank's rows alike, and every circular pad is made
in one, `_padded`, counted in `generator.wrap_pads`. Served (nothing for
autograd to record, on the card) that is one launch of a CUDA kernel
that reads the input once and writes the padded block once, counted in
`wrap.launches`, and a partial convolution's masking of its input rides
that pass; elsewhere it is `F.pad` and `wrap_width`.

Every layer takes a rank's rows of a map split over a process group (a
`spatial.Band`: the generator of `SE3DSModel(mesh=...)` with a 'spatial'
axis above 1) where it takes a tensor: a layer that reads across rows
runs its whole-image op on the window of input rows that its output rows
read, which `spatial` fetches with the height pads as fill rows, and pads
the width itself. `spatial` decides only which rows each rank holds and
reads.

Rematerialisation (`remat`, inside `rematerialise()`): the models run
their blocks as segments of `torch.utils.checkpoint`, which keeps each
segment's inputs and recomputes the rest in the backward pass. The
layers update state inside `forward` (`u`, the running statistics), so
a segment's recompute sees the `u` its forward started from and writes
no state: each update happens once per forward, as under the JAX
package's functional `jax.checkpoint`.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterable, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from se3ds_torch import tracing
from se3ds_torch.models import spatial
from se3ds_torch.ops import epilogue_cuda
from se3ds_torch.ops import wrap_cuda

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99  # Flax/Keras: r = 0.99 * r + 0.01 * batch statistic.

IntPair = Union[int, Tuple[int, int]]


def _to_pair(v: IntPair) -> Tuple[int, int]:
  return (v, v) if isinstance(v, int) else tuple(v)


# Per thread: whether `remat` checkpoints (set by `rematerialise`, read in
# the thread that runs the forward) and whether a segment is being
# recomputed (set around the recompute, in the thread of the backward).
_REMAT = threading.local()


@contextlib.contextmanager
def rematerialise(enabled: bool = True):
  """Within: `remat` runs its segments under `torch.utils.checkpoint`
  (where gradients are on)."""
  previous = getattr(_REMAT, 'enabled', False)
  _REMAT.enabled = enabled
  try:
    yield
  finally:
    _REMAT.enabled = previous


def recomputing() -> bool:
  """Whether a rematerialised segment is being recomputed: layers then
  write no state."""
  return getattr(_REMAT, 'recomputing', False)


def remat(fn: Callable, *args, state_of: Iterable[nn.Module] = (),
          residual: Optional[torch.Tensor] = None):
  """`fn(*args)`, one checkpointed segment inside `rematerialise()`.

  `state_of` are the modules whose state `fn` reads: their `u` buffers
  are put back to the values this forward started from while the
  segment is recomputed, then to the advanced values. The running
  statistics are never read in training, so they need no such care;
  `recomputing()` keeps every layer from writing state twice.
  Non-reentrant checkpoints: the train step differentiates with
  `torch.autograd.grad`, which the reentrant variant does not support.
  The models draw no random numbers, so no RNG state is replayed.

  `residual`, a tensor that `fn(*args, residual=residual)` adds to its
  result (in its epilogue): a checkpointed segment adds it outside,
  `residual + fn(*args)`, so that the checkpoint holds no more than the
  segment's own inputs.
  """
  if not (getattr(_REMAT, 'enabled', False) and torch.is_grad_enabled()):
    return fn(*args) if residual is None else fn(*args, residual=residual)
  states = [buffer for module in state_of
            for name, buffer in module.named_buffers()
            if name.rsplit('.', 1)[-1] == 'u']
  started = [u.clone() for u in states]

  @contextlib.contextmanager
  def replay():
    advanced = [u.clone() for u in states]
    for u, value in zip(states, started):
      u.copy_(value)
    _REMAT.recomputing = True
    try:
      yield
    finally:
      _REMAT.recomputing = False
      for u, value in zip(states, advanced):
        u.copy_(value)

  out = checkpoint_lib.checkpoint(
      fn, *args, use_reentrant=False, preserve_rng_state=False,
      context_fn=lambda: (contextlib.nullcontext(), replay()))
  return out if residual is None else residual + out



def pad2d(x: torch.Tensor, padding: int, circular_pad: bool = False,
          constant_value: float = 0.0) -> torch.Tensor:
  """Pads (N, C, H, W) by `padding` on H and W (eval PadLayer).

  Height pads with `constant_value`; width wraps circularly when
  `circular_pad`, else pads with `constant_value` too.
  """
  if padding == 0:
    return x
  p = padding
  if circular_pad:
    padded = F.pad(x, (0, 0, p, p), value=constant_value)
    return wrap_width(padded, p)
  return F.pad(x, (p, p, p, p), value=constant_value)


def wrap_width(x: torch.Tensor, margin: int) -> torch.Tensor:
  """Circularly extends (N, C, H, W) by `margin` columns on each side.

  Column j of the result equals x[..., (j - margin) mod W].
  """
  if margin == 0:
    return x
  width = x.shape[-1]
  if margin <= width:
    return torch.cat([x[..., -margin:], x, x[..., :margin]], dim=-1)
  # Margin wider than the pano itself (tiny shapes): mod-index gather.
  idx = torch.arange(-margin, width + margin, device=x.device) % width
  return x.index_select(-1, idx)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
  """TF 'SAME' padding (before, after) for one spatial dim."""
  out = -(-size // s)
  total = max((out - 1) * s + k - size, 0)
  return total // 2, total - total // 2


class Pads(NamedTuple):
  """How a window op pads its input: zero rows above and below, and zero
  columns left and right or, with `wrap`, the width extended circularly
  (`wrap_width`, left == right)."""
  top: int
  bottom: int
  left: int
  right: int
  wrap: bool = False


def conv_pads(size: Tuple[int, int], kernel: Tuple[int, int],
              strides: Tuple[int, int], padding: str = 'SAME',
              fused_pad: int = 0, wraps: bool = False) -> Pads:
  """The one rule of how a convolution (or a mask's window sum) pads an
  input of `size` (rows, columns), as the Flax layer pads it: its
  `fused_pad` on every side, the width wrapped where `wraps` (a circular
  layer at eval), else TF's 'SAME' pads (the odd row and column after)
  or none ('VALID'). The whole-image and the row-band routes both pad by
  it."""
  if fused_pad:
    return Pads(fused_pad, fused_pad, fused_pad, fused_pad, wraps)
  padding = padding.upper()
  if padding == 'VALID':
    return Pads(0, 0, 0, 0)
  if padding != 'SAME':
    raise ValueError(f'Unsupported padding {padding!r}')
  return Pads(*_same_pads(size[0], kernel[0], strides[0]),
              *_same_pads(size[1], kernel[1], strides[1]))


def _padded(x: torch.Tensor, pads: Pads,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """x, times `scale` (an (N, 1, H, W) tensor: a partial convolution's
  mask) where given, padded by `pads` (a copy where any pad is not zero
  or a scale is given).

  A circular pad counts in `generator.wrap_pads`. On a CUDA tensor, with
  nothing for autograd to record, it is one launch of the wrap kernel
  (`ops/wrap_cuda.py`), which multiplies and pads in one read and write;
  a fault there raises. Everywhere else the ops below, whose bits the
  kernel gives on the card.
  """
  top, bottom, left, right, wrap = pads
  if wrap:
    tracing.counter('generator.wrap_pads')
    if x.is_cuda and not _records([x] if scale is None else [x, scale], ()):
      return wrap_cuda.launch(x, top, bottom, left, scale)
  if scale is not None:
    x = x * scale
  if wrap:
    return wrap_width(F.pad(x, (0, 0, top, bottom)) if top or bottom else x,
                      left)
  if top or bottom or left or right:
    return F.pad(x, (left, right, top, bottom))
  return x


def mask_window_sum(mask: torch.Tensor, kh: int, kw: int, strides: IntPair,
                    fused_pad: int = 0, circular: bool = False,
                    padding: str = 'SAME') -> torch.Tensor:
  """Window-sum of a 0/1 mask (the partial-conv mask propagation).

  Equal to a convolution with a ones kernel: every partial sum is an
  integer <= kh*kw <= 49, exact in float32 and in bf16.
  """
  sh, sw = _to_pair(strides)
  if kh == 1 and kw == 1 and fused_pad == 0:
    return mask if (sh == 1 and sw == 1) else mask[:, :, ::sh, ::sw]
  padded = _padded(mask, conv_pads(mask.shape[-2:], (kh, kw), (sh, sw),
                                   padding, fused_pad, circular))
  return F.avg_pool2d(padded, (kh, kw), stride=(sh, sw), divisor_override=1)


def store_served_kernels(module: nn.Module, dtype: torch.dtype) -> None:
  """Stores every conv kernel (4-D parameter) of `module` once in `dtype`
  and in channels_last memory, the layout of the served activations, so
  that no call copies or transposes a kernel. BatchNorm parameters and
  biases stay float32."""
  for param in module.parameters():
    if param.dim() == 4:
      param.data = param.data.to(dtype, memory_format=torch.channels_last)


def _count_conv(x: torch.Tensor, weight: torch.Tensor) -> None:
  """Counts a convolution of `x` by `weight` in `generator.convs`, and in
  `generator.nchw_convs` where either is not channels_last memory (a
  one-channel tensor and a 1x1 kernel are both layouts at once)."""
  tracing.counter('generator.convs')
  if not (x.is_contiguous(memory_format=torch.channels_last)
          and weight.is_contiguous(memory_format=torch.channels_last)):
    tracing.counter('generator.nchw_convs')


def _conv2d(x: torch.Tensor, weight: torch.Tensor, **kwargs) -> torch.Tensor:
  _count_conv(x, weight)
  return F.conv2d(x, weight, **kwargs)


def _conv_padded(x: torch.Tensor, weight: torch.Tensor,
                 strides: Tuple[int, int], pads: Pads,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """A VALID convolution of x (times `scale`, a partial convolution's
  mask, where given) padded by `pads`, the product and the pad made by
  `_padded`. A zero pad is the convolution's own, as the JAX package pads
  in training: no padded copy of `x` is made (and kept for the backward)
  but for TF SAME's odd row and column, after, which cuDNN's symmetric
  pad cannot add."""
  if pads.wrap:
    return _conv2d(_padded(x, pads, scale), weight, stride=strides)
  top, bottom, left, right, _ = pads
  x = _padded(x, Pads(0, bottom - top, 0, right - left), scale)
  return _conv2d(x, weight, stride=strides, padding=(top, left))


def spectral_normalize(w_flat: torch.Tensor, u: torch.Tensor,
                       eps: float = 1e-10
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """One power-iteration step (JAX `layers.spectral_normalize`).

  Args:
    w_flat: (K, O) flattened kernel.
    u: (1, O) power-iteration state.

  Returns:
    w_norm: (K, O) kernel divided by (sigma + eps).
    u_hat: (1, O) updated state.
    sigma: (1, 1) estimated top singular value.

  The power iteration is outside the gradient (the JAX version's
  `stop_gradient` on u_hat and v_hat): sigma's gradient flows through
  w_flat alone.
  """
  with torch.no_grad():
    w = w_flat.detach()
    v = u @ w.T
    v_hat = v / (torch.linalg.norm(v) + eps)
    u_new = v_hat @ w
    u_hat = u_new / (torch.linalg.norm(u_new) + eps)
  sigma = (v_hat @ w_flat) @ u_hat.T
  return w_flat / (sigma + eps), u_hat, sigma


def normalized_kernel(weight: torch.Tensor, u: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(OIHW kernel / (sigma + eps), u_hat) from one power iteration.

  The flattened (K, O) layout differs from the JAX package's HWIO one
  only by a row permutation, which leaves sigma unchanged. Float32.
  """
  out = weight.shape[0]
  w_flat = weight.reshape(out, -1).T.to(torch.float32)
  w_norm, u_hat, _ = spectral_normalize(w_flat, u.to(torch.float32))
  return w_norm.T.reshape(weight.shape), u_hat


# -- what follows a convolution ----------------------------------------------

RELU = 'relu'
# An epilogue's activation: None, RELU, or a LeakyReLU's negative slope.
Activation = Union[None, str, float]


class ConvOutput(NamedTuple):
  """A tensor on its way out of a layer, with the ops that follow it.

  out: a convolution's output without its bias, or a tensor that is no
    convolution's output (`conv` None).
  conv: the convolution module that made `out`: its bias follows, and
    with `window_sum` (a `PartialConv`) its renormalisation.
  window_sum: the mask's window sums of a partial convolution.
  bn: the `SyncBatchNorm` that follows, or None.
  """
  out: torch.Tensor
  conv: Optional[nn.Module] = None
  window_sum: Optional[torch.Tensor] = None
  bn: Optional[nn.Module] = None


def epilogue(x: ConvOutput, act: Activation = None,
             residual: Union[None, torch.Tensor, ConvOutput] = None,
             after_act: bool = False, post_bn: Optional[nn.Module] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """Everything between one convolution and the next, for every block in
  training and in serving alike.

  In order: x's partial-conv renormalisation or its bias, then its
  BatchNorm; `residual` (a tensor, or a second convolution's output
  settled as x is) added before the activation `act` or, with
  `after_act`, after it; then `post_bn`, the next layer's leading
  BatchNorm. Returns (the result in x.out's dtype, x's update mask where
  x is a partial convolution's output, else None).

  Two routes, by what the call observes. On a CUDA tensor, with every
  module in eval and nothing for autograd to record, it is one launch of
  the epilogue kernel (`ops/epilogue_cuda.py`), which reads each
  convolution output once and counts them in `generator.fused_convs`; a
  fault there raises. Everywhere else (training, which needs autograd and
  batch statistics; the CPU) it is `epilogue_plain`, whose bits the
  kernel gives on the card. Given a rank's rows (`spatial.Band`s as
  x.out, the residual or its out), it runs on their tensors and returns
  bands.
  """
  if isinstance(x.out, spatial.Band):  # a rank's rows: on their tensors
    out, update_mask = epilogue(_rows_of(x), act, _rows_of(residual),
                                after_act, post_bn)
    return x.out.like(out), (None if update_mask is None
                             else x.out.like(update_mask))
  stages = [x] + ([residual] if isinstance(residual, ConvOutput) else [])
  modules = [m for s in stages for m in (s.conv, s.bn) if m is not None]
  modules += [post_bn] if post_bn is not None else []
  tensors = [s.out for s in stages]
  tensors += [residual] if isinstance(residual, torch.Tensor) else []
  if (not x.out.is_cuda or any(m.training for m in modules)
      or _records(tensors, modules)):
    return epilogue_plain(x, act, residual, after_act, post_bn)
  if isinstance(residual, torch.Tensor):
    residual = epilogue_cuda.Operand(residual)
  elif residual is not None:
    residual = _operand(residual)
  code, slope = ((epilogue_cuda.NONE, 0.0) if act is None else
                 (epilogue_cuda.RELU, 0.0) if act == RELU else
                 (epilogue_cuda.LEAKY, float(act)))
  out = epilogue_cuda.launch(_operand(x), residual, code, slope, after_act,
                             _norm(post_bn))
  tracing.counter('generator.fused_convs',
                  sum(s.conv is not None for s in stages))
  return out


def _rows_of(value):
  """A `Band`'s tensor, a `ConvOutput` of bands' with its tensors, or
  `value` itself."""
  if isinstance(value, spatial.Band):
    return value.x
  if isinstance(value, ConvOutput):
    return ConvOutput(*map(_rows_of, value))
  return value


def epilogue_plain(x: ConvOutput, act: Activation = None,
                   residual: Union[None, torch.Tensor, ConvOutput] = None,
                   after_act: bool = False,
                   post_bn: Optional[nn.Module] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """`epilogue` as the layers' own ops, on any device, under autograd:
  computed in float32 (float64 tensors in float64) in the order above
  and cast back to x.out's dtype once. For float32 and float64 tensors
  these are exactly the composed ops (a tensor's `.to` its own dtype is
  the tensor itself), with batch statistics in training."""
  out, update_mask = _settle(x)
  if isinstance(residual, ConvOutput):
    residual = _settle(residual)[0]
  elif residual is not None:
    residual = _wide(residual)
  if residual is not None and not after_act:
    out = out + residual
  if act == RELU:
    out = F.relu(out)
  elif act is not None:
    out = F.leaky_relu(out, negative_slope=act)
  if residual is not None and after_act:
    out = out + residual
  if post_bn is not None:
    out = _normalise(post_bn, out)
  if update_mask is not None:
    update_mask = _cast(update_mask, x.window_sum.dtype)
  return _cast(out, x.out.dtype), update_mask


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  # The test first spares a training step's hundreds of no-op calls.
  return x if x.dtype == dtype else x.to(dtype)


def _wide(x: torch.Tensor) -> torch.Tensor:
  """x in float32, or in its own dtype where that is wider (float64)."""
  return _cast(x, torch.promote_types(x.dtype, torch.float32))


def _settle(s: ConvOutput) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """s.out in float32 with its renormalisation or bias and its BatchNorm;
  (that, the update mask or None)."""
  out, update_mask = _wide(s.out), None
  if s.window_sum is not None:
    out, update_mask = s.conv.renormalise(out, _wide(s.window_sum))
  elif s.conv is not None and s.conv.bias is not None:
    out = out + s.conv.bias[:, None, None]
  if s.bn is not None:
    out = _normalise(s.bn, out)
  return out, update_mask


def _normalise(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
  return bn(x) if bn.training else bn.normalise(x)


def _records(tensors: Iterable[torch.Tensor],
             modules: Iterable[nn.Module]) -> bool:
  """Whether autograd records ops on these tensors or parameters."""
  return torch.is_grad_enabled() and (
      any(t.requires_grad for t in tensors) or
      any(p.requires_grad for m in modules for p in m.parameters(False)))


def _norm(bn: Optional[nn.Module]):
  return None if bn is None else (bn.running_mean, bn.running_var, bn.weight,
                                  bn.bias)


def _operand(s: ConvOutput) -> epilogue_cuda.Operand:
  area = 1.0
  if s.window_sum is not None:
    kh, kw = s.conv.weight.shape[-2:]
    area = float(kh * kw)
  return epilogue_cuda.Operand(s.out, s.window_sum, area,
                               None if s.conv is None else s.conv.bias,
                               _norm(s.bn))


class _Conv(nn.Module):
  """Conv2D with Keras defaults and TF-style padding (OIHW weight)."""

  def __init__(self, in_features: int, features: int, kernel_size: IntPair,
               strides: IntPair = 1, padding: str = 'SAME',
               use_bias: bool = True, fused_pad: int = 0,
               circular: bool = False):
    super().__init__()
    kh, kw = _to_pair(kernel_size)
    self.strides = _to_pair(strides)
    self.padding = padding
    self.fused_pad = fused_pad
    self.circular = circular
    self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
    self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

  @property
  def wraps(self) -> bool:
    """Circular width padding: at eval only."""
    return self.circular and not self.training

  def pads(self, size: Tuple[int, int]) -> Pads:
    """How this convolution pads an input of `size` (rows, columns)."""
    return conv_pads(size, self.weight.shape[-2:], self.strides, self.padding,
                     self.fused_pad, self.wraps)

  def _window(self, band: spatial.Band) -> spatial.Window:
    """The input rows that this rank's output rows read, padded as the
    whole map is: fill rows beyond its edges, the width padded here."""
    pads = self.pads(band.shape[-2:])
    window = band.strided(self.weight.shape[-2], self.strides[0], pads.top,
                          pads.bottom)
    return window._replace(x=_padded(window.x,
                                     pads._replace(top=0, bottom=0)))

  def _conv(self, x: Union[torch.Tensor, spatial.Band],
            weight: Optional[torch.Tensor] = None,
            scale: Optional[torch.Tensor] = None):
    """The convolution of x by `weight` (default the module's own),
    without the bias; a whole-image x times `scale` first, where given (a
    rank's rows take none: `PartialConv._convolve_rows` masks them)."""
    weight = (self.weight if weight is None else weight).to(x.dtype)
    if isinstance(x, spatial.Band):
      assert scale is None, 'a rank\'s rows are masked by _convolve_rows'
      window = self._window(x)
      return window.keep(_conv2d(window.x, weight, stride=self.strides))
    return _conv_padded(x, weight, self.strides, self.pads(x.shape[-2:]),
                        scale)

  def convolve(self, x: torch.Tensor) -> torch.Tensor:
    """The convolution, without the bias (which its epilogue adds)."""
    return self._conv(x)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return epilogue(ConvOutput(self.convolve(x), self))[0]


class Conv2D(_Conv):
  """Plain Conv2D (glorot kernel, zero bias)."""


class SpectralConv(_Conv):
  """Spectral-normalised Conv2D (Miyato et al.).

  Folded (`fold=True`, the serving form): at eval the power-iteration
  state never updates, so the kernel was divided by (sigma + eps) once at
  load (`folding.torch_state_dict_from_flax`, `folding.serving_state_dict`).
  Unfolded: each call runs one power iteration from the buffer `u`
  (1, O) and convolves with kernel / (sigma + eps); `u` is stored only in
  training.
  """

  def __init__(self, *args, fold: bool = True, **kwargs):
    super().__init__(*args, **kwargs)
    self.fold = fold
    self.register_buffer(
        'u', None if fold else torch.empty(1, self.weight.shape[0]))

  def convolve(self, x: torch.Tensor) -> torch.Tensor:
    if self.fold:
      return self._conv(x)
    weight, u_hat = normalized_kernel(self.weight, self.u)
    if self.training and not recomputing():
      self.u.copy_(u_hat)
    return self._conv(x, weight)


class PartialConv(_Conv):
  """Partial convolution (Liu et al.) with mask renormalisation.

  Convolves with the RAW kernel even where the reference keeps a
  spectral-norm state: the reference computes the normalised kernel but
  never uses it, so nothing is folded here. With `spectral_norm` and
  `fold=False` the module keeps that inert state, a buffer `u`, and
  updates it in training. Returns (out, update_mask).
  """

  def __init__(self, *args, spectral_norm: bool = False, fold: bool = True,
               **kwargs):
    super().__init__(*args, **kwargs)
    self.register_buffer(
        'u', torch.empty(1, self.weight.shape[0])
        if spectral_norm and not fold else None)

  def convolve(self, feature: torch.Tensor,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the convolution of the masked features, without the bias; the
    mask's window sums), which `renormalise` or an epilogue take."""
    if isinstance(feature, spatial.Band):
      return self._convolve_rows(feature, mask)
    kh, kw = self.weight.shape[-2:]
    if mask is None:
      mask = torch.ones_like(feature[:, :1])
    if self.u is not None and self.training and not recomputing():
      with torch.no_grad():
        self.u.copy_(normalized_kernel(self.weight, self.u)[1])
    window_sum = mask_window_sum(mask, kh, kw, self.strides,
                                 fused_pad=self.fused_pad,
                                 circular=self.wraps, padding=self.padding)
    # The masking `feature * mask`: in the wrap's one pass where the input
    # is padded circularly.
    return self._conv(feature, scale=mask), window_sum

  def _convolve_rows(self, feature: spatial.Band,
                     mask: Optional[spatial.Band]
                     ) -> Tuple[spatial.Band, spatial.Band]:
    """`convolve` (eval) on a rank's rows: the masked features and the
    mask in one window."""
    x = feature.x
    mask = torch.ones_like(x[:, :1]) if mask is None else mask.x
    window = self._window(feature.like(torch.cat([x * mask, mask], dim=1)))
    kh, kw = self.weight.shape[-2:]
    window_sum = mask_window_sum(window.x[:, -1:], kh, kw, self.strides,
                                 padding='VALID')
    out = _conv2d(window.x[:, :-1], self.weight.to(x.dtype),
                  stride=self.strides)
    return window.keep(out), window.keep(window_sum)

  def forward(self, feature: torch.Tensor,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    out, window_sum = self.convolve(feature, mask)
    return epilogue(ConvOutput(out, self, window_sum))

  def renormalise(self, out: torch.Tensor, window_sum: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, update_mask) from the convolution of the masked features
    (without the bias) and the mask's window sums."""
    kh, kw = self.weight.shape[-2:]
    eps = 1e-6
    # (kh * kw) / (window_sum + eps), as PyTorch divides a number by a
    # tensor: the reciprocal, then the product.
    mask_ratio = (window_sum + eps).reciprocal() * (kh * kw)
    update_mask = torch.clamp(window_sum, 0.0, 1.0)
    mask_ratio = mask_ratio * update_mask
    if self.bias is not None:
      # The reference subtracts a bias the conv never added.
      bias = self.bias.to(out.dtype)[:, None, None]
      out = (out - bias) * mask_ratio + bias
      out = out * update_mask
    else:
      out = out * mask_ratio
    return out, update_mask


class Conv2DTranspose(nn.Module):
  """Transposed conv with the output geometry of Flax `nn.ConvTranspose`.

  The weight is (in, out, kh, kw), the PyTorch layout, already flipped
  spatially (Flax convolves the dilated input with the unflipped kernel).
  'SAME'/'VALID' pads follow `jax.lax.conv_transpose`.
  """

  def __init__(self, in_features: int, features: int, kernel_size: IntPair,
               strides: IntPair = 1, padding: str = 'SAME',
               use_bias: bool = True):
    super().__init__()
    kh, kw = _to_pair(kernel_size)
    self.strides = _to_pair(strides)
    self.padding = padding.upper()
    if self.padding not in ('SAME', 'VALID'):
      raise ValueError(f'Unsupported padding {padding!r}')
    self.weight = nn.Parameter(torch.empty(in_features, features, kh, kw))
    self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

  def _pads(self, k: int, s: int) -> Tuple[int, int]:
    """(before, after) pads of `conv_transpose2d`'s full output, which
    pads the dilated input by k - 1 on both sides, to lax.conv_transpose's
    pads of it (negative: crops)."""
    if self.padding == 'SAME':
      pad_len = k + s - 2
      pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
      pad_len = k + s - 2 + max(k - s, 0)
      pad_a = k - 1
    return pad_a - (k - 1), pad_len - pad_a - (k - 1)

  def convolve(self, x: Union[torch.Tensor, spatial.Band]):
    """The transposed convolution, without the bias."""
    weight = self.weight.to(x.dtype)
    (sh, sw), (kh, kw) = self.strides, weight.shape[-2:]
    top, bottom = self._pads(kh, sh)
    window = None
    if isinstance(x, spatial.Band):  # its rows: the window crops them
      window = x.transposed(kh, sh, top, bottom)
      x, top, bottom = window.x, 0, 0
    _count_conv(x, weight)
    out = F.conv_transpose2d(x, weight, stride=self.strides)
    crops = [*self._pads(kw, sw), top, bottom]
    if any(crops):
      out = F.pad(out, crops)
    return out if window is None else window.keep(out)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return epilogue(ConvOutput(self.convolve(x), self))[0]


class SyncBatchNorm(nn.Module):
  """BatchNorm, eps 1e-3 (Keras), over (N, H, W).

  Eval: the stored statistics. Training: the batch mean and the biased
  batch variance normalise; then, as Flax's `nn.BatchNorm` does,
  r = 0.99 * r + 0.01 * batch for both running statistics, with the
  biased variance (PyTorch's own update uses momentum 0.1 and the
  unbiased variance). Flax computes the variance as E[x^2] - E[x]^2
  clipped at 0; without a process group this is the two-pass value,
  equal up to rounding. Under a `torch.distributed` process group the
  batch is the global one, as GSPMD normalises it: the per-channel
  count, sum and sum of squares are summed over the ranks with the
  gradient flowing through, and the variance is Flax's E[x^2] - E[x]^2.
  """

  def __init__(self, features: int):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(features))
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer('running_mean', torch.zeros(features))
    self.register_buffer('running_var', torch.ones(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if not self.training:
      return epilogue(ConvOutput(x, bn=self))[0]
    if dist.is_initialized():
      return self._global_batch_norm(x)
    if not recomputing():
      with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        self._update_statistics(mean, var)
    return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                        eps=BN_EPSILON)

  def normalise(self, x: torch.Tensor) -> torch.Tensor:
    """The eval normalisation in Flax's formula, (x - mean) * mul + bias
    with mul = rsqrt(var + eps) * weight per channel, in x's dtype; the
    reciprocal square root is the correctly rounded reciprocal of the
    correctly rounded square root, as the epilogue kernel computes it."""
    mul = torch.sqrt(self.running_var + BN_EPSILON).reciprocal() * self.weight
    return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
            + self.bias[:, None, None])

  @torch.no_grad()
  def _update_statistics(self, mean: torch.Tensor, var: torch.Tensor):
    for stat, value in ((self.running_mean, mean), (self.running_var, var)):
      stat.copy_(BN_MOMENTUM * stat + (1 - BN_MOMENTUM) * value)

  def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    count = torch.full((1,), xf.numel() / xf.shape[1], device=x.device)
    sums = torch.cat([count, xf.sum(dim=(0, 2, 3)),
                      (xf * xf).sum(dim=(0, 2, 3))])
    sums = dist_nn.all_reduce(sums)
    total, channel_sum, channel_sq = sums[:1], *sums[1:].chunk(2)
    mean = channel_sum / total
    var = torch.clamp(channel_sq / total - mean * mean, min=0.0)
    if not recomputing():
      self._update_statistics(mean.detach(), var.detach())
    scale = self.weight * torch.rsqrt(var + BN_EPSILON)
    shift = self.bias - mean * scale
    return (xf * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


class InstanceNorm(nn.Module):
  """Instance normalisation (tfa InstanceNormalization defaults): the
  biased variance over (H, W) per example and channel, eps 1e-3, a
  per-channel scale and shift (Flax `gamma`, `beta`)."""

  def __init__(self, features: int, epsilon: float = 1e-3):
    super().__init__()
    self.epsilon = epsilon
    self.weight = nn.Parameter(torch.ones(features))
    self.bias = nn.Parameter(torch.zeros(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.instance_norm(x, weight=self.weight, bias=self.bias,
                           eps=self.epsilon)


def max_pool_2x2_same(x: Union[torch.Tensor, spatial.Band]):
  """MaxPool2D(pool=2, strides=2, padding=SAME)."""
  h, w = x.shape[-2:]
  if isinstance(x, spatial.Band):  # its rows: -inf below an odd map
    window = x.strided(2, 2, 0, h % 2, fill=float('-inf'))
    return window.keep(max_pool_2x2_same(window.x))
  if h % 2 or w % 2:
    x = F.pad(x, (0, w % 2, 0, h % 2), value=float('-inf'))
  return F.max_pool2d(x, 2, 2)


def upsample_2x_nearest(x: Union[torch.Tensor, spatial.Band]):
  """Keras UpSampling2D() (nearest, x2), in the input's memory layout."""
  if isinstance(x, spatial.Band):  # its rows: row o is input row o // 2
    window = x.transposed(2, 2, 0, 0)
    return window.keep(upsample_2x_nearest(window.x))
  return F.interpolate(x, scale_factor=2, mode='nearest')


def avg_pool_3x3_stride2_same(x: torch.Tensor) -> torch.Tensor:
  """tf.nn.avg_pool(ksize=3, strides=2, padding='SAME').

  TF's SAME pad is asymmetric (0 before and 1 after at an even size) and
  the divisor counts only the in-bounds elements of each window, so a
  symmetric `count_include_pad=False` pool is not it.
  """
  pads = conv_pads(x.shape[-2:], (3, 3), (2, 2))
  window_sum = lambda t: F.avg_pool2d(_padded(t, pads), 3, 2,
                                      divisor_override=1)
  return window_sum(x) / window_sum(torch.ones_like(x[:1, :1]))


class Bottleneck(nn.Module):
  """ResNet bottleneck with mask threading."""

  def __init__(self, in_features: int, filters: int, strides: int = 1,
               expansion: int = 4, has_downsample: bool = False,
               circular_pad: bool = False, spectral: bool = False,
               fold: bool = True):
    super().__init__()
    partial = lambda *a, **k: PartialConv(*a, spectral_norm=spectral,
                                          fold=fold, **k)
    self.conv1 = partial(in_features, filters, 1, 1, 'SAME')
    self.act1_bn = SyncBatchNorm(filters)
    self.conv2 = partial(filters, filters, 3, strides, 'VALID',
                         fused_pad=1, circular=circular_pad)
    self.act2_bn = SyncBatchNorm(filters)
    self.conv3 = partial(filters, expansion * filters, 1, 1, 'SAME')
    self.act3_bn = SyncBatchNorm(expansion * filters)
    if has_downsample:
      self.downsample = partial(in_features, expansion * filters, 1,
                                strides, 'SAME', use_bias=False)
      self.ds_norm = SyncBatchNorm(expansion * filters)
    else:
      self.downsample = None

  def forward(self, x, mask=None):
    out, window_sum = self.conv1.convolve(x, mask)
    out, update_mask = epilogue(
        ConvOutput(out, self.conv1, window_sum, self.act1_bn), RELU)
    out, window_sum = self.conv2.convolve(out, update_mask)
    out, update_mask = epilogue(
        ConvOutput(out, self.conv2, window_sum, self.act2_bn), RELU)
    out, window_sum = self.conv3.convolve(out, update_mask)
    residual = x
    if self.downsample is not None:
      ds_out, ds_window_sum = self.downsample.convolve(x, mask)
      residual = ConvOutput(ds_out, self.downsample, ds_window_sum,
                            self.ds_norm)
    return epilogue(ConvOutput(out, self.conv3, window_sum, self.act3_bn),
                    RELU, residual)


class ResStack(nn.Module):
  """Stack of Bottleneck blocks.

  `inplanes` is the Flax module's attribute, which decides the
  downsample branch; `in_features` is the real input width.
  """

  def __init__(self, in_features: int, inplanes: int, planes: int,
               blocks: int, strides: int = 1, expansion: int = 4,
               circular_pad: bool = False, spectral: bool = False,
               fold: bool = True):
    super().__init__()
    has_downsample = strides != 1 or inplanes != planes * expansion
    self.num_blocks = blocks
    for i in range(blocks):
      self.add_module(f'block{i}', Bottleneck(
          in_features if i == 0 else planes * expansion, planes,
          strides=strides if i == 0 else 1, expansion=expansion,
          has_downsample=has_downsample and i == 0,
          circular_pad=circular_pad, spectral=spectral, fold=fold))

  def forward(self, x, mask=None):
    for i in range(self.num_blocks):
      block = getattr(self, f'block{i}')
      x, mask = remat(block, x, mask, state_of=(block,))
    return x, mask


def conv_fn(spectral: bool, fold: bool = True):
  if spectral:
    return lambda *a, **k: SpectralConv(*a, fold=fold, **k)
  return Conv2D


class TransBasicBlock(nn.Module):
  """Residual block with optional transposed-conv upsampling."""

  def __init__(self, inplanes: int, planes: int, strides: int = 1,
               has_upsample: bool = False, circular_pad: bool = False,
               spectral: bool = False, fold: bool = True):
    super().__init__()
    conv = conv_fn(spectral, fold)
    self.main_conv1 = conv(inplanes, inplanes, 3, 1, 'VALID', use_bias=False,
                           fused_pad=1, circular=circular_pad)
    self.main_bn1 = SyncBatchNorm(inplanes)
    if has_upsample and strides != 1:
      self.main_convt = Conv2DTranspose(inplanes, planes, 3, strides, 'SAME',
                                        use_bias=False)
    else:
      self.main_conv2 = conv(inplanes, planes, 3, strides, 'VALID',
                             use_bias=False, fused_pad=1,
                             circular=circular_pad)
    self.main_bn2 = SyncBatchNorm(planes)
    self.has_upsample = has_upsample
    if has_upsample:
      if strides != 1:
        self.up_convt = Conv2DTranspose(inplanes, planes, 2, strides,
                                        'VALID', use_bias=False)
      else:
        self.up_conv = conv(inplanes, planes, 1, strides, use_bias=False)
      self.up_bn = SyncBatchNorm(planes)

  def forward(self, x):
    out, _ = epilogue(ConvOutput(self.main_conv1.convolve(x), self.main_conv1,
                                 bn=self.main_bn1), RELU)
    up = self.main_convt if hasattr(self, 'main_convt') else self.main_conv2
    out = up.convolve(out)
    residual = x
    if self.has_upsample:
      res = self.up_convt if hasattr(self, 'up_convt') else self.up_conv
      residual = ConvOutput(res.convolve(x), res, bn=self.up_bn)
    out, _ = epilogue(ConvOutput(out, up, bn=self.main_bn2), RELU, residual)
    return out


class ResStackTranspose(nn.Module):
  """Stack of TransBasicBlocks, upsampling in the last block."""

  def __init__(self, inplanes: int, planes: int, blocks: int,
               strides: int = 1, circular_pad: bool = False,
               spectral: bool = False, fold: bool = True):
    super().__init__()
    self.num_blocks = blocks
    for i in range(blocks - 1):
      self.add_module(f'block{i}', TransBasicBlock(
          inplanes, inplanes, circular_pad=circular_pad, spectral=spectral,
          fold=fold))
    self.add_module(f'block{blocks - 1}', TransBasicBlock(
        inplanes, planes, strides=strides,
        has_upsample=strides != 1 or inplanes != planes,
        circular_pad=circular_pad, spectral=spectral, fold=fold))

  def forward(self, x):
    for i in range(self.num_blocks):
      block = getattr(self, f'block{i}')
      x = remat(block, x, state_of=(block,))
    return x
