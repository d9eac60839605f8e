"""Plain PyTorch reference of one SE3DS GAN training step.

A frozen copy of what `train_step` computes on a batch of 2k examples
split into `d_step_per_g_step` chunks (the recipe's 2):

1. a discriminator step on the first chunk: the generator runs forward
   in training without gradients (its spectral `u` advances); the
   discriminator, in training, takes concat([fake, real]) (RGB + depth,
   NHWC) and its hinge loss, averaged over the scales, is minimised;
2. a joint step on the second: the generator forward in training; the
   losses 100 * the masked depth L1 (valid where 0 < depth < 1), 10 *
   the world-consistency L1 against the guidance (masked by proj_mask *
   (1 - blurred_mask)), and the generator's hinge loss on the
   discriminator at eval (its pre-update weights, `u` not stored); the
   generator's gradient; then a discriminator step on the detached fake;
   then the EMA (a copy of the generator in the first
   `num_batched_steps` steps).

Every gradient is clipped per tensor to norm 5, then Adam (Keras' eps
1e-7) steps. Spectral kernels are divided by sigma from one power
iteration from `u` at each forward (`generator.prepare`). Float32, TF32
off, no kernel of the program; blocks recompute in the backward pass to
fit one card.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference import generator as ref_gen

CLIP_NORM = 5.0
ADAM_EPS = 1e-7


class Hyper(NamedTuple):
  g_lr: float
  d_lr: float
  beta1: float
  beta2: float
  d_step_per_g_step: int
  lambda_gan: float
  lambda_wc: float
  lambda_depth: float
  ema_decay: float


class Adam:
  """torch.optim.Adam's update with its state made at construction."""

  def __init__(self, params: List[torch.Tensor], lr: float, beta1: float,
               beta2: float):
    self.params, self.lr, self.b1, self.b2 = params, lr, beta1, beta2
    self.m = [torch.zeros_like(p) for p in params]
    self.v = [torch.zeros_like(p) for p in params]
    self.t = 0

  @torch.no_grad()
  def step(self, grads: List[torch.Tensor]) -> None:
    self.t += 1
    c1 = 1 - self.b1 ** self.t
    c2 = math.sqrt(1 - self.b2 ** self.t)
    for p, g, m, v in zip(self.params, grads, self.m, self.v):
      m.mul_(self.b1).add_(g, alpha=1 - self.b1)
      v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
      p.addcdiv_(m, v.sqrt().div_(c2).add_(ADAM_EPS), value=-self.lr / c1)


def clip(grads: List[torch.Tensor]) -> List[torch.Tensor]:
  out = []
  for g in grads:
    norm = torch.linalg.vector_norm(g.float())
    out.append(g * torch.clamp(CLIP_NORM / torch.clamp(norm, min=1e-20),
                               max=1.0))
  return out


def _pair(rgb, depth, inputs):
  fake = torch.cat([rgb, depth], dim=-1)
  real = torch.cat([inputs['image'], inputs['depth']], dim=-1)
  return torch.cat([fake, real], dim=0)


def _hinge(logits: List[torch.Tensor]):
  """(generator loss, discriminator loss) averaged over the scales."""
  gen, disc = 0.0, 0.0
  for logit in logits:
    fake, real = logit.chunk(2, dim=0)
    gen = gen + torch.mean(-fake)
    disc = disc + torch.mean(F.relu(1.0 - real) + F.relu(1.0 + fake))
  return gen / len(logits), disc / len(logits)


def _generator_inputs(inputs):
  return {k: inputs[k] for k in ('proj_image', 'proj_depth', 'proj_mask',
                                 'blurred_mask')}


class Trainer:
  """The generator, the discriminator, their Adams and the EMA."""

  def __init__(self, generator: ref_gen.Generator, discriminator,
               hyper: Hyper):
    self.g, self.d, self.hyper = generator, discriminator, hyper
    self.g_params = list(generator.parameters())
    self.d_params = list(discriminator.parameters())
    self.g_opt = Adam(self.g_params, hyper.g_lr, hyper.beta1, hyper.beta2)
    self.d_opt = Adam(self.d_params, hyper.d_lr, hyper.beta1, hyper.beta2)
    self.ema = [p.detach().clone() for p in self.g_params]

  def _d_update(self, rgb, depth, inputs):
    ref_gen.prepare(self.d, store_u=True)
    _, disc = _hinge(self.d(_pair(rgb, depth, inputs)))
    disc = self.hyper.lambda_gan * disc
    grads = torch.autograd.grad(disc, self.d_params, allow_unused=True,
                                materialize_grads=True)
    self.d_opt.step(clip(grads))
    return disc.detach()

  def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One train_step; returns the joint step's losses."""
    hp = self.hyper
    k = hp.d_step_per_g_step
    chunks = [{key: v.chunk(k)[i] for key, v in batch.items()}
              for i in range(k)]
    for inputs in chunks[:-1]:
      with torch.no_grad():
        ref_gen.prepare(self.g, store_u=True)
        depth, rgb = self.g(_generator_inputs(inputs))
      self._d_update(rgb, depth, inputs)
    inputs = chunks[-1]
    ref_gen.prepare(self.g, store_u=True)
    depth_out, rgb = self.g(_generator_inputs(inputs))
    depth = inputs['depth']
    valid = ((depth > 0) & (depth < 1)).float()
    count = torch.clamp(valid.sum(dim=(1, 2, 3)), min=1.0)
    depth_loss = hp.lambda_depth * torch.mean(
        (torch.abs(depth_out - depth) * valid).sum(dim=(1, 2, 3)) / count)
    mask = inputs['proj_mask'] * (1 - inputs['blurred_mask'])
    wc = (torch.abs(rgb - inputs['proj_image']) * mask).sum(dim=(1, 2, 3))
    wc = wc / rgb.shape[-1] / torch.clamp(mask.sum(dim=(1, 2, 3)), min=1.0)
    wc = hp.lambda_wc * torch.mean(wc)
    with torch.no_grad():
      ref_gen.prepare(self.d, store_u=False)
    gen_gan, _ = _hinge(self.d(_pair(rgb, depth_out, inputs)))
    gen_gan = hp.lambda_gan * gen_gan
    gen_loss = gen_gan + wc + depth_loss
    grads = torch.autograd.grad(gen_loss, self.g_params, allow_unused=True,
                                materialize_grads=True)
    self.g_opt.step(clip(grads))
    disc = self._d_update(rgb.detach(), depth_out.detach(), inputs)
    with torch.no_grad():
      for e, p in zip(self.ema, self.g_params):
        e.sub_((e - p) * (1.0 - hp.ema_decay))
    return {'gen/gen_loss': gen_loss.detach(), 'dis/disc_loss': disc,
            'gen/depth_loss': depth_loss.detach(), 'gen/wc_loss': wc.detach(),
            'gen/gen_gan_loss': gen_gan.detach()}
