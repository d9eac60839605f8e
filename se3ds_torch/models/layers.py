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
  global batch.

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
from typing import Callable, Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from se3ds_torch import tracing

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


def remat(fn: Callable, *args, state_of: Iterable[nn.Module] = ()):
  """`fn(*args)`, one checkpointed segment inside `rematerialise()`.

  `state_of` are the modules whose state `fn` reads: their `u` buffers
  are put back to the values this forward started from while the
  segment is recomputed, then to the advanced values. The running
  statistics are never read in training, so they need no such care;
  `recomputing()` keeps every layer from writing state twice.
  Non-reentrant checkpoints: the train step differentiates with
  `torch.autograd.grad`, which the reentrant variant does not support.
  The models draw no random numbers, so no RNG state is replayed.
  """
  if not (getattr(_REMAT, 'enabled', False) and torch.is_grad_enabled()):
    return fn(*args)
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

  return checkpoint_lib.checkpoint(
      fn, *args, use_reentrant=False, preserve_rng_state=False,
      context_fn=lambda: (contextlib.nullcontext(), replay()))



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


def _pad_for(x: torch.Tensor, kh: int, kw: int, strides: Tuple[int, int],
             padding: str, fused_pad: int, circular: bool) -> torch.Tensor:
  """Pads x for a VALID window op, as the Flax layer pads it at eval."""
  if fused_pad:
    return pad2d(x, fused_pad, circular_pad=circular)
  padding = padding.upper()
  if padding == 'VALID':
    return x
  if padding != 'SAME':
    raise ValueError(f'Unsupported padding {padding!r}')
  top, bottom = _same_pads(x.shape[-2], kh, strides[0])
  left, right = _same_pads(x.shape[-1], kw, strides[1])
  if top or bottom or left or right:
    x = F.pad(x, (left, right, top, bottom))
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
  padded = _pad_for(mask, kh, kw, (sh, sw), padding, fused_pad, circular)
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


def circular_conv2d(x: torch.Tensor, weight: torch.Tensor, strides: IntPair,
                    pad: int, circular: bool) -> torch.Tensor:
  """`pad2d(x, pad, circular)` followed by a VALID convolution (OIHW).

  A zero pad is the convolution's own, as the JAX package pads in
  training: no padded copy of `x` is made (and kept for the backward).
  """
  if not circular:
    return _conv2d(x, weight, stride=_to_pair(strides), padding=pad)
  return _conv2d(pad2d(x, pad, circular_pad=True), weight,
                 stride=_to_pair(strides))


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

  def _conv(self, x: torch.Tensor,
            weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    weight = (self.weight if weight is None else weight).to(x.dtype)
    if self.fused_pad:
      return circular_conv2d(x, weight, self.strides, self.fused_pad,
                             self.wraps)
    kh, kw = weight.shape[-2:]
    if self.padding.upper() != 'SAME':
      x = _pad_for(x, kh, kw, self.strides, self.padding, 0, False)
      return _conv2d(x, weight, stride=self.strides)
    # The symmetric part of TF's SAME pad is the convolution's own; the
    # odd row and column, after, is padded here.
    top, bottom = _same_pads(x.shape[-2], kh, self.strides[0])
    left, right = _same_pads(x.shape[-1], kw, self.strides[1])
    if bottom > top or right > left:
      x = F.pad(x, (0, right - left, 0, bottom - top))
    return _conv2d(x, weight, stride=self.strides, padding=(top, left))

  def _add_bias(self, out: torch.Tensor) -> torch.Tensor:
    if self.bias is None:
      return out
    return out + self.bias.to(out.dtype)[:, None, None]


class Conv2D(_Conv):
  """Plain Conv2D (glorot kernel, zero bias)."""

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self._add_bias(self._conv(x))


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

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.fold:
      return self._add_bias(self._conv(x))
    weight, u_hat = normalized_kernel(self.weight, self.u)
    if self.training and not recomputing():
      self.u.copy_(u_hat)
    return self._add_bias(self._conv(x, weight))


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

  def forward(self, feature: torch.Tensor,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    kh, kw = self.weight.shape[-2:]
    if mask is None:
      mask = torch.ones_like(feature[:, :1])
    if self.u is not None and self.training and not recomputing():
      with torch.no_grad():
        self.u.copy_(normalized_kernel(self.weight, self.u)[1])
    window_sum = mask_window_sum(mask, kh, kw, self.strides,
                                 fused_pad=self.fused_pad,
                                 circular=self.wraps, padding=self.padding)
    return self.renormalise(self._conv(feature * mask), window_sum)

  def renormalise(self, out: torch.Tensor, window_sum: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, update_mask) from the convolution of the masked features
    (without the bias) and the mask's window sums."""
    kh, kw = self.weight.shape[-2:]
    eps = 1e-6
    mask_ratio = (kh * kw) / (window_sum + eps)
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
    """(before, after) pads of the dilated input (lax.conv_transpose)."""
    if self.padding == 'SAME':
      pad_len = k + s - 2
      pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
      pad_len = k + s - 2 + max(k - s, 0)
      pad_a = k - 1
    return pad_a, pad_len - pad_a

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    weight = self.weight.to(x.dtype)
    kh, kw = weight.shape[-2:]
    # conv_transpose2d with padding 0 pads the dilated input by k-1 on
    # both sides; crop (or zero-extend) to the Flax pads.
    _count_conv(x, weight)
    out = F.conv_transpose2d(x, weight, stride=self.strides)
    crops = []
    for k, s in ((kw, self.strides[1]), (kh, self.strides[0])):
      before, after = self._pads(k, s)
      crops += [before - (k - 1), after - (k - 1)]
    if any(crops):
      out = F.pad(out, crops)
    if self.bias is not None:
      out = out + self.bias.to(out.dtype)[:, None, None]
    return out


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
      return F.batch_norm(x, self.running_mean, self.running_var,
                          self.weight, self.bias, training=False,
                          eps=BN_EPSILON)
    if dist.is_initialized():
      return self._global_batch_norm(x)
    if not recomputing():
      with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        self._update_statistics(mean, var)
    return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                        eps=BN_EPSILON)

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


def max_pool_2x2_same(x: torch.Tensor) -> torch.Tensor:
  """MaxPool2D(pool=2, strides=2, padding=SAME)."""
  h, w = x.shape[-2:]
  if h % 2 or w % 2:
    x = F.pad(x, (0, w % 2, 0, h % 2), value=float('-inf'))
  return F.max_pool2d(x, 2, 2)


def upsample_2x_nearest(x: torch.Tensor) -> torch.Tensor:
  """Keras UpSampling2D() (nearest, x2), in the input's memory layout."""
  return F.interpolate(x, scale_factor=2, mode='nearest')


def avg_pool_3x3_stride2_same(x: torch.Tensor) -> torch.Tensor:
  """tf.nn.avg_pool(ksize=3, strides=2, padding='SAME').

  TF's SAME pad is asymmetric (0 before and 1 after at an even size) and
  the divisor counts only the in-bounds elements of each window, so a
  symmetric `count_include_pad=False` pool is not it.
  """
  top, bottom = _same_pads(x.shape[-2], 3, 2)
  left, right = _same_pads(x.shape[-1], 3, 2)
  pads = (left, right, top, bottom)
  window_sum = lambda t: F.avg_pool2d(F.pad(t, pads), 3, 2,
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
    out, update_mask = self.conv1(x, mask)
    out = F.relu(self.act1_bn(out))
    out, update_mask = self.conv2(out, update_mask)
    out = F.relu(self.act2_bn(out))
    out, update_mask = self.conv3(out, update_mask)
    out = self.act3_bn(out)
    residual = x
    if self.downsample is not None:
      residual, _ = self.downsample(x, mask)
      residual = self.ds_norm(residual)
    return F.relu(out + residual), update_mask


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
    out = F.relu(self.main_bn1(self.main_conv1(x)))
    up = self.main_convt if hasattr(self, 'main_convt') else self.main_conv2
    out = self.main_bn2(up(out))
    residual = x
    if self.has_upsample:
      res = self.up_convt if hasattr(self, 'up_convt') else self.up_conv
      residual = self.up_bn(res(x))
    return F.relu(out + residual)


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
