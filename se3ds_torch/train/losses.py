"""GAN losses for SE3DS training (port of `se3ds_tpu.train.losses`)."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from se3ds_torch import device as device_lib
from se3ds_torch import tracing


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
  """VAE KLD; zeros in this release."""
  return -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar))


def wc_loss(generated_images: torch.Tensor, real_images: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
  """World-consistency masked L1, NHWC. Returns a per-example (N,) loss."""
  loss = torch.abs(generated_images - real_images)
  loss = torch.sum(loss * mask, dim=(1, 2, 3)) / device_lib.divisor(
      generated_images.shape[-1], loss)
  return loss / torch.clamp(torch.sum(mask, dim=(1, 2, 3)), min=1.0)


def discriminator_hinge_loss(real_logit: torch.Tensor,
                             fake_logit: torch.Tensor) -> torch.Tensor:
  return F.relu(1.0 - real_logit) + F.relu(1.0 + fake_logit)


def generator_hinge_loss(fake_logit: torch.Tensor) -> torch.Tensor:
  return -fake_logit


def split_disc_outputs(logit_outputs: List[List[torch.Tensor]]):
  """Splits every map of a discriminator run on concat([fake, real]) back
  into its (fake, real) halves along axis 0."""
  fake_list, real_list = [], []
  for sub in logit_outputs:
    halves = [out.chunk(2, dim=0) for out in sub]
    fake_list.append([fake for fake, _ in halves])
    real_list.append([real for _, real in halves])
  return fake_list, real_list


def multiscale_gan_losses(fake_logit_list, real_logit_list):
  """Final-logit hinge losses averaged over sub-discriminators:
  (generator loss, discriminator loss)."""
  gen_loss = 0.0
  disc_loss = 0.0
  for sub_fake, sub_real in zip(fake_logit_list, real_logit_list):
    gen_loss += torch.mean(generator_hinge_loss(sub_fake[-1]))
    disc_loss += torch.mean(discriminator_hinge_loss(sub_real[-1],
                                                     sub_fake[-1]))
  n = len(fake_logit_list)
  return gen_loss / n, disc_loss / n


def clip_grad_per_leaf(grads: Sequence[torch.Tensor],
                       clip_norm: float = 5.0) -> List[torch.Tensor]:
  """tf.clip_by_norm on each tensor: g * min(1, clip / max(|g|, 1e-20)),
  the norm in float32 (the span `clip` of `se3ds_torch.tracing`)."""
  with tracing.span('clip', timed=grads[0].is_cuda):
    norms = torch.stack(torch._foreach_norm([g.float() for g in grads]))
    factors = torch.clamp(
        torch.full_like(norms, clip_norm) / torch.clamp(norms, min=1e-20),
        max=1.0)
    return [g * f.to(g.dtype) for g, f in zip(grads, factors.unbind())]


def mean_leaf_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
  """Mean of per-tensor L2 norms, NaN replaced with 0 (a metric only)."""
  m = torch.stack(torch._foreach_norm(list(grads))).mean()
  return torch.where(torch.isnan(m), torch.zeros_like(m), m)
