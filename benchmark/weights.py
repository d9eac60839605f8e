"""Seeded random weights in the Flax layout of the JAX package.

The benchmark makes the weights, hands the program a host copy through
its public bridge (`SE3DSModel(variables=...)`, which converts the Flax
layout and folds the spectral kernels itself), and hands the reference
the same tree on the device. Every leaf lives in one float32 buffer, so
the weights take a few large calls on the card and one copy to the host:

- kernels (HWIO, or (kh, kw, in, out) for a transposed conv) are
  glorot-uniform: one uniform draw over all of them, scaled per kernel;
- the power-iteration states `u` (1, O) of the spectral convs are
  N(0, 0.05) truncated at two standard deviations, one draw;
- biases and BatchNorm shifts 0, scales and stored variances 1, stored
  means 0, as Flax initialises them (the serving driver then sets the
  output heads' last scale and bias, `drivers/serving.make_weights`).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from benchmark.reference import generator as ref_gen


class Leaf(NamedTuple):
  collection: str          # 'params', 'batch_stats' or 'spectral'
  path: Tuple[str, ...]
  shape: Tuple[int, ...]
  init: str                # 'glorot', 'u', 'zeros' or 'ones'
  fans: Tuple[int, int] = (0, 0)


def flax_leaves(model: torch.nn.Module, trainable: bool = False
                ) -> List[Leaf]:
  """The Flax leaves of a reference model (built on any device). The
  trainable form also carries the inert `u` of the spectral-norm partial
  convolutions."""
  out = []
  for name, module, kind in ref_gen.leaves(model):
    path = tuple(name.split('.'))
    if kind == 'in':
      (features,) = module.weight.shape
      out += [Leaf('params', path + ('gamma',), (features,), 'ones'),
              Leaf('params', path + ('beta',), (features,), 'zeros')]
      continue
    if kind == 'bn':
      (features,) = module.weight.shape
      out += [Leaf('params', path + ('bn', 'scale'), (features,), 'ones'),
              Leaf('params', path + ('bn', 'bias'), (features,), 'zeros'),
              Leaf('batch_stats', path + ('bn', 'mean'), (features,),
                   'zeros'),
              Leaf('batch_stats', path + ('bn', 'var'), (features,), 'ones')]
      continue
    w = module.weight.shape
    if kind == 'convt':  # torch (in, out, kh, kw) -> Flax (kh, kw, in, out)
      path = path + ('convt',)
      shape, fans = (w[2], w[3], w[0], w[1]), (w[0], w[1])
    else:  # torch OIHW -> Flax HWIO
      shape, fans = (w[2], w[3], w[1], w[0]), (w[1], w[0])
    receptive = w[2] * w[3]
    out.append(Leaf('params', path + ('kernel',), shape, 'glorot',
                    (fans[0] * receptive, fans[1] * receptive)))
    if module.bias is not None:
      out.append(Leaf('params', path + ('bias',), (w[0] if kind == 'conv'
                                                    else w[1],), 'zeros'))
    if kind == 'conv' and (module.spectral or (trainable and module.inert_u)):
      out.append(Leaf('spectral', path + ('u',), (1, w[0]), 'u'))
  return out


class Weights:
  """One flat float32 buffer and the Flax tree of views into it."""

  def __init__(self, leaves: List[Leaf], flat: torch.Tensor):
    self.leaves = leaves
    self.flat = flat
    self.tree = _tree(leaves, flat)

  @classmethod
  @torch.no_grad()
  def make(cls, leaves: List[Leaf], seed: int, device) -> 'Weights':
    sizes = [math.prod(leaf.shape) for leaf in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    flat.uniform_(-1.0, 1.0, generator=generator)
    weights = cls(leaves, flat)
    us = [(leaf, t) for leaf, t in zip(leaves, weights.views) if
          leaf.init == 'u']
    u_draw = torch.empty(sum(t.numel() for _, t in us), device=device)
    torch.nn.init.trunc_normal_(u_draw, std=0.05, a=-0.1, b=0.1,
                                generator=generator)
    offset = 0
    for (_, view), size in zip(us, [t.numel() for _, t in us]):
      view.copy_(u_draw[offset:offset + size].view(view.shape))
      offset += size
    for leaf, view in zip(leaves, weights.views):
      if leaf.init == 'glorot':
        view.mul_(math.sqrt(6.0 / sum(leaf.fans)))
      elif leaf.init == 'zeros':
        view.zero_()
      elif leaf.init == 'ones':
        view.fill_(1.0)
    return weights

  @property
  def views(self) -> List[torch.Tensor]:
    out, offset = [], 0
    for leaf in self.leaves:
      size = math.prod(leaf.shape)
      out.append(self.flat[offset:offset + size].view(leaf.shape))
      offset += size
    return out

  def leaf(self, collection: str, path: Tuple[str, ...]) -> torch.Tensor:
    node = self.tree[collection]
    for part in path:
      node = node[part]
    return node

  def to(self, device) -> 'Weights':
    return Weights(self.leaves, self.flat.to(device))

  def numpy_tree(self) -> Dict:
    """The tree as numpy views of the host buffer (what the program's
    Flax bridge reads); call it on a `to('cpu')` copy."""
    return _tree(self.leaves, self.flat.numpy())


def _tree(leaves, flat):
  tree: Dict = {'params': {}, 'batch_stats': {}, 'spectral': {}}
  offset = 0
  for leaf in leaves:
    size = math.prod(leaf.shape)
    node = tree[leaf.collection]
    for part in leaf.path[:-1]:
      node = node.setdefault(part, {})
    node[leaf.path[-1]] = flat[offset:offset + size].reshape(leaf.shape)
    offset += size
  return tree
