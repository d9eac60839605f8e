"""Weights for the port's models: the Flax bridge, random init and the
fold from the trainable form to the serving form.

`torch_state_dict_from_flax` converts the JAX package's variable trees
({'params', 'batch_stats', 'spectral'}, as numpy arrays or anything
`np.asarray` reads) into the port's `state_dict`:

* A folded SpectralConv's kernel (`fold=True`, the serving form) is
  divided by (sigma + eps) in float32, with the math of
  `layers.spectral_normalize` (one power iteration from the stored `u`).
  The folded SpectralConvs are found from the port's own modules:
  PartialConv kernels also carry a `u` in the reference, but their raw
  kernel is what the reference convolves with, so they stay raw. Without
  a 'spectral' collection the kernels are taken as already folded (the
  JAX `fold_spectral_variables` output).
* A module that holds a `u` buffer (an unfolded SpectralConv, or an
  unfolded PartialConv with spectral_norm) gets its raw kernel and its
  `u` from the 'spectral' collection.
* Conv kernels go from HWIO to OIHW; Flax ConvTranspose kernels
  (kh, kw, in, out) go to PyTorch's (in, out, kh, kw) with a spatial flip.
* BatchNorm scale/bias/mean/var become weight/bias/running_mean/var;
  InstanceNorm gamma/beta become weight/bias.

`load_train_state_from_flax` carries a whole JAX `TrainState` (G, D, EMA,
both Adam states, the step) into the port's `train.state.TrainState`.
`serving_state_dict` folds a trained generator into the serving form.
`init_random_` gives fresh models Keras-style random weights from a
`torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from se3ds_torch.models import layers

_LEAF_NAMES = {'kernel': 'weight', 'scale': 'weight', 'gamma': 'weight',
               'bias': 'bias', 'beta': 'bias', 'mean': 'running_mean',
               'var': 'running_var', 'u': 'u'}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
  out = {}
  for key, value in tree.items():
    path = prefix + (key,)
    if isinstance(value, Mapping):
      out.update(_flatten(value, path))
    else:
      out[path] = np.asarray(value, np.float32)
  return out


def spectral_conv_names(model: nn.Module) -> set:
  """Module names of every folded SpectralConv in `model`."""
  return {name for name, m in model.named_modules()
          if isinstance(m, layers.SpectralConv) and m.fold}


def power_iteration_names(model: nn.Module) -> set:
  """Module names of every module with a power-iteration buffer `u`."""
  return {name for name, m in model.named_modules()
          if getattr(m, 'u', None) is not None}


def fold_kernel(kernel_oihw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
  """Divides an OIHW kernel by (sigma + eps) from one power iteration."""
  return layers.normalized_kernel(kernel_oihw, u)[0]


def torch_kernel_from_flax(kernel: np.ndarray, transposed: bool
                           ) -> torch.Tensor:
  """HWIO -> OIHW, or a Flax ConvTranspose (kh, kw, in, out) kernel ->
  PyTorch's (in, out, kh, kw), spatially flipped."""
  kernel = np.asarray(kernel, np.float32)
  if transposed:
    kernel = kernel[::-1, ::-1].transpose(2, 3, 0, 1)
  else:
    kernel = kernel.transpose(3, 2, 0, 1)
  return torch.from_numpy(np.ascontiguousarray(kernel))


def torch_tensors_from_flax(tree: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
  """Every leaf of a Flax tree (params, a collection, or an optimizer
  moment shaped like params) under the port's state_dict key, converted
  to the port's layout and nothing else (no fold)."""
  out = {}
  for (*module_path, leaf), value in _flatten(tree).items():
    name = '.'.join(p for p in module_path if p not in ('bn', 'convt'))
    key = '.'.join(filter(None, (name, _LEAF_NAMES[leaf])))
    if leaf == 'kernel':
      out[key] = torch_kernel_from_flax(value, 'convt' in module_path)
    else:
      out[key] = torch.from_numpy(np.array(value))
  return out


def torch_state_dict_from_flax(variables: Mapping[str, Any],
                               model: nn.Module) -> Dict[str, torch.Tensor]:
  """The port's state_dict from the JAX package's variables.

  Args:
    variables: {'params', 'batch_stats'[, 'spectral']} trees.
    model: the port's module the state_dict is for; its folded
      SpectralConvs decide which kernels are folded, its `u` buffers which
      power-iteration states are carried.
  """
  folded = spectral_conv_names(model)
  with_u = power_iteration_names(model)
  spectral = torch_tensors_from_flax(variables.get('spectral', {}))
  state = torch_tensors_from_flax(variables['params'])
  state.update(torch_tensors_from_flax(variables.get('batch_stats', {})))
  for key, value in spectral.items():
    name = key[:-len('.u')]
    if name in with_u:
      state[key] = value
    elif name in folded:
      state[f'{name}.weight'] = fold_kernel(state[f'{name}.weight'], value)
  return state


def fold_state_dict(state: Mapping[str, torch.Tensor], spectral_convs
                    ) -> Dict[str, torch.Tensor]:
  """A trainable generator's state_dict in the serving form: the kernel
  of each module named in `spectral_convs` divided by sigma from its
  stored `u` (what its eval forward convolves with), and no `u`
  buffers."""
  out = {k: v for k, v in state.items() if not k.endswith('.u')}
  for name in spectral_convs:
    weight = state[f'{name}.weight']
    out[f'{name}.weight'] = fold_kernel(weight, state[f'{name}.u']).to(
        weight.dtype)
  return out


def serving_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
  """The state_dict of the serving (`spectral_fold=True`) form of a
  trainable generator (`fold_state_dict` of its unfolded
  SpectralConvs)."""
  return fold_state_dict(
      model.state_dict(),
      [name for name, module in model.named_modules()
       if isinstance(module, layers.SpectralConv) and not module.fold])


def adam_state_from_flax(optimizer, model: nn.Module,
                         adam: Mapping[str, Any]) -> None:
  """Sets `optimizer`'s per-parameter state (a `parallel.mesh.Zero1Adam`
  of `model`, which keeps its rank's shards) from an optax Adam state
  {'mu', 'nu', 'count'} (trees shaped like the Flax params of `model`)."""
  names = [name for name, _ in model.named_parameters()]
  mu = torch_tensors_from_flax(adam['mu'])
  nu = torch_tensors_from_flax(adam['nu'])
  if mu.keys() != set(names):
    raise ValueError(f'Adam state and {type(model).__name__} differ: '
                     f'{sorted(mu.keys() ^ set(names))[:5]}')
  step = float(np.asarray(adam['count']))
  (group,) = optimizer.param_groups
  optimizer.load_state_dict({
      'param_groups': [{**{k: v for k, v in group.items() if k != 'params'},
                        'params': list(range(len(names)))}],
      'state': {i: {'step': torch.tensor(step, dtype=torch.float32),
                    'exp_avg': mu[name], 'exp_avg_sq': nu[name]}
                for i, name in enumerate(names)}})


def load_train_state_from_flax(state, flax_state: Mapping[str, Any]) -> None:
  """Carries a JAX `TrainState` into the port's `TrainState`, in place.

  Args:
    state: a `se3ds_torch.train.state.TrainState` of the same models.
    flax_state: the JAX state as numpy trees: 'step', 'g_params',
      'g_state' ({'batch_stats', 'spectral'}), 'd_params', 'd_state'
      ({'spectral'}), 'ema_params', 'ema_state', and 'g_opt_state' /
      'd_opt_state' as {'mu', 'nu', 'count'} of the optax Adam state.
  """
  for model, params, collections in (
      (state.generator, 'g_params', 'g_state'),
      (state.discriminator, 'd_params', 'd_state'),
      (state.ema, 'ema_params', 'ema_state')):
    whole = torch_state_dict_from_flax(
        {'params': flax_state[params], **flax_state[collections]}, model)
    if model is state.ema:  # this rank's ZeRO-1 shards
      whole = state.data.shard_state_dict(whole, model, state.g_opt.axes)
    model.load_state_dict(whole)
  adam_state_from_flax(state.g_opt, state.generator, flax_state['g_opt_state'])
  adam_state_from_flax(state.d_opt, state.discriminator,
                       flax_state['d_opt_state'])
  state.step = int(np.asarray(flax_state['step']))


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> None:
  """Keras-style random weights in place, then the spectral fold.

  Kernels are glorot-uniform (fans over the receptive field), biases and
  norm shifts zero, norm scales and variances one (as constructed), and
  each spectral conv gets a power-iteration state u ~ N(0, 0.05)
  truncated at two standard deviations, as the Flax initialisers draw
  them: stored in its `u` buffer, or folded into a folded SpectralConv's
  kernel.
  """
  folded = spectral_conv_names(model)
  device = generator.device
  for name, module in model.named_modules():
    weight = getattr(module, 'weight', None)
    if weight is None or weight.dim() != 4:
      continue
    if isinstance(module, layers.Conv2DTranspose):
      fan_in = weight.shape[0] * weight[0, 0].numel()
      fan_out = weight.shape[1] * weight[0, 0].numel()
    else:
      fan_out = weight.shape[0] * weight[0, 0].numel()
      fan_in = weight.shape[1] * weight[0, 0].numel()
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    value = torch.empty(weight.shape, device=device).uniform_(
        -limit, limit, generator=generator)
    if name in folded or getattr(module, 'u', None) is not None:
      u = torch.empty((1, weight.shape[0]), device=device)
      nn.init.trunc_normal_(u, std=0.05, a=-0.1, b=0.1, generator=generator)
      if name in folded:
        value = fold_kernel(value, u)
      else:
        module.u.copy_(u)
    weight.copy_(value)
