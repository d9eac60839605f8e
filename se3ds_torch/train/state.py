"""Train state and step functions for SE3DS GAN training (port of
`se3ds_tpu.train.state`).

* `TrainState` bundles the generator and discriminator (their buffers
  hold the BatchNorm statistics and the power-iteration states `u`), the
  EMA generator, both Adam optimizers and the global step: the 6-way
  bundle the checkpoints hold. The JAX functions return a new state; these
  update the modules and optimizers in place.
* `train_step` is one cluster element: (d_step_per_g_step - 1)
  discriminator-only updates, then one joint G+D update, on a batch split
  along axis 0. `train_cluster` loops over a stack of batches and
  averages the metrics.

The traps the JAX step keeps, kept here:
* The D-only step runs G forward in train mode without gradients, so G's
  BatchNorm statistics and `u` move in every chunk.
* The G loss sees D at eval (power iteration without storing `u`) and
  with the pre-update D parameters; only G's parameters get gradients.
* The D update then runs D in training, which stores `u`, on the detached
  fake of that same G forward.
* Gradients are clipped per tensor, then Adam steps.

Data parallel (`TrainState.data`, `parallel.mesh`): each rank steps on its
slice of the batch; BatchNorm normalises over the global batch, the
gradients are averaged over the ranks before the clip, Adam's moments
and the EMA's parameters are ZeRO-1 shards (`mesh.Zero1Adam`), and the
metrics are the global batch's. At world 1 nothing of this runs.

`hp.remat` rematerialises the G and D forwards that gradients flow
through, block by block (`layers.rematerialise`); the results equal the
stored-activation path's.

The step's parts are spans of `se3ds_torch.tracing`, timed on the card:
`train.step`, with the children `d_only` (`train_d_step`) and `g_d`
(`train_g_d_step`); inside them `d_update` (`_update_discriminator`),
`backward` (`_gradients`), `clip` (`losses.clip_grad_per_leaf`), `adam`
(`_apply_gradients`) and `ema` (`update_ema`), so `train.step.g_d.adam`
is the generator's Adam step. `train.steps` counts the steps.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from se3ds_torch import tracing
from se3ds_torch.models import folding
from se3ds_torch.models import layers
from se3ds_torch.parallel import mesh
from se3ds_torch.train import losses as losses_lib


class GANHParams(NamedTuple):
  """Loss weights and schedule knobs (the JAX package's)."""
  lambda_gan: float = 1.0
  lambda_kld: float = 10.0
  lambda_wc: float = 10.0
  lambda_depth: float = 100.0
  predict_depth: bool = True
  dis_use_pred_depth: bool = True
  mask_blurred: bool = True
  d_step_per_g_step: int = 2
  ema_decay: float = 0.999
  ema_init_step: int = 0
  num_batched_steps: int = 100
  grad_clip_norm: float = 5.0
  # Rematerialise the forwards that gradients flow through.
  remat: bool = False


@dataclasses.dataclass
class TrainState:
  """At a world above 1 the EMA's parameters and the optimizers'
  moments are this rank's ZeRO-1 shards."""
  step: int
  generator: nn.Module
  discriminator: nn.Module
  ema: nn.Module
  g_opt: mesh.Zero1Adam
  d_opt: mesh.Zero1Adam
  data: mesh.DataParallel = mesh.DataParallel()


def make_optimizers(generator: nn.Module, discriminator: nn.Module,
                    g_lr: float, d_lr: float, beta1: float, beta2: float,
                    data: mesh.DataParallel = mesh.DataParallel()):
  """Two Adam optimizers with Keras' epsilon 1e-7, over `data`'s
  ZeRO-1 shards."""
  g_opt = mesh.Zero1Adam(generator, data, lr=g_lr, betas=(beta1, beta2),
                         eps=1e-7)
  d_opt = mesh.Zero1Adam(discriminator, data, lr=d_lr, betas=(beta1, beta2),
                         eps=1e-7)
  return g_opt, d_opt


def create_train_state(generator: nn.Module, discriminator: nn.Module,
                       g_lr: float, d_lr: float, beta1: float,
                       beta2: float,
                       data: Optional[mesh.DataParallel] = None
                       ) -> TrainState:
  """A state at step 0 around initialised models; the EMA generator
  starts as a copy of the generator (its ZeRO-1 shards). `data`: the
  initialised process group's world by default."""
  if folding.spectral_conv_names(generator):
    raise ValueError('training needs the unfolded generator '
                     '(ResNetGenerator(spectral_fold=False))')
  data = data or mesh.DataParallel.current()
  g_opt, d_opt = make_optimizers(generator, discriminator, g_lr, d_lr, beta1,
                                 beta2, data)
  ema = copy.deepcopy(generator).requires_grad_(False)
  data.shard_module_(ema, g_opt.axes)
  return TrainState(step=0, generator=generator, discriminator=discriminator,
                    ema=ema, g_opt=g_opt, d_opt=d_opt, data=data)


def _prepare_inputs(inputs: Dict[str, torch.Tensor], hp: GANHParams):
  inputs = dict(inputs)
  if not hp.mask_blurred:
    inputs['blurred_mask'] = torch.zeros_like(inputs['blurred_mask'])
  return inputs


def _disc_pair_input(generated, depth_out, inputs, hp: GANHParams):
  """concat([fake, real]) along axis 0, each RGB + depth (NHWC)."""
  depth = inputs['depth']
  fake = torch.cat([generated, depth_out if hp.dis_use_pred_depth else depth],
                   dim=-1)
  real = torch.cat([inputs['image'], depth], dim=-1)
  return torch.cat([fake, real], dim=0)


def _apply_gradients(optimizer: mesh.Zero1Adam,
                     grads: List[torch.Tensor]) -> None:
  with tracing.span('adam', timed=grads[0].is_cuda):
    optimizer.step(grads)


def _gradients(loss: torch.Tensor, module: nn.Module,
               data: mesh.DataParallel) -> List[torch.Tensor]:
  """d loss / d module's parameters, averaged over the ranks."""
  with tracing.span('backward', timed=loss.is_cuda):
    grads = torch.autograd.grad(loss, list(module.parameters()),
                                allow_unused=True, materialize_grads=True)
    return data.average(list(grads))


def _update_discriminator(state: TrainState, generated, depth_out, inputs,
                          hp: GANHParams):
  """One D update on the detached fake; returns (disc loss, mean clipped
  gradient norm)."""
  with tracing.span('d_update', timed=generated.is_cuda):
    discriminator = state.discriminator.train()
    with layers.rematerialise(hp.remat):
      logit_outputs = discriminator(
          _disc_pair_input(generated, depth_out, inputs, hp))
    fake_list, real_list = losses_lib.split_disc_outputs(logit_outputs)
    _, disc_loss = losses_lib.multiscale_gan_losses(fake_list, real_list)
    disc_loss = hp.lambda_gan * disc_loss
    grads = _gradients(disc_loss, discriminator, state.data)
    grads = losses_lib.clip_grad_per_leaf(grads, hp.grad_clip_norm)
    grad_norm = losses_lib.mean_leaf_norm(grads)
    _apply_gradients(state.d_opt, grads)
    return disc_loss.detach(), grad_norm


def train_d_step(state: TrainState, inputs: Dict[str, torch.Tensor],
                 hp: GANHParams) -> None:
  """D-only update; G runs forward in train mode (statistics and `u`
  update, no gradients)."""
  with tracing.span('d_only', timed=inputs['image'].is_cuda):
    inputs = _prepare_inputs(inputs, hp)
    with torch.no_grad():
      g_out = state.generator.train()(inputs)
    _update_discriminator(state, g_out[6], g_out[3], inputs, hp)


def train_g_d_step(state: TrainState, inputs: Dict[str, torch.Tensor],
                   hp: GANHParams) -> Dict[str, torch.Tensor]:
  """Joint G+D update; returns the step's metrics (0-dim tensors)."""
  with tracing.span('g_d', timed=inputs['image'].is_cuda):
    return _g_d_step(state, inputs, hp)


def _g_d_step(state: TrainState, inputs: Dict[str, torch.Tensor],
              hp: GANHParams) -> Dict[str, torch.Tensor]:
  inputs = _prepare_inputs(inputs, hp)
  generator = state.generator.train()
  blurred_mask = inputs['blurred_mask']
  depth = inputs['depth']
  target_spatial_mask = ((depth > 0) & (depth < 1)).float()
  num_spatial_pixels = torch.clamp(
      torch.sum(target_spatial_mask, dim=(1, 2, 3)), min=1.0)

  with layers.rematerialise(hp.remat):
    _, _, kld, depth_out, _, _, generated = generator(inputs)
  depth_loss = torch.zeros((), device=depth.device)
  if hp.predict_depth:
    depth_loss = torch.abs(depth_out - depth) * target_spatial_mask
    depth_loss = torch.sum(depth_loss, dim=(1, 2, 3)) / num_spatial_pixels
    depth_loss = hp.lambda_depth * torch.mean(depth_loss)
  kld_nan = torch.isnan(kld)
  kld_nan_count = torch.sum(kld_nan.float())
  kld_term = hp.lambda_kld * torch.mean(
      torch.where(kld_nan, torch.zeros_like(kld), kld))
  wc = hp.lambda_wc * losses_lib.wc_loss(
      generated, inputs['proj_image'], inputs['proj_mask'] * (1 - blurred_mask))
  wc = torch.mean(wc)

  # D at eval: one power iteration from the stored u, nothing stored, the
  # pre-update parameters; only G's parameters are differentiated.
  with layers.rematerialise(hp.remat):
    logit_outputs = state.discriminator.eval()(
        _disc_pair_input(generated, depth_out, inputs, hp))
  fake_list, real_list = losses_lib.split_disc_outputs(logit_outputs)
  gen_gan_loss, _ = losses_lib.multiscale_gan_losses(fake_list, real_list)
  gen_gan_loss = hp.lambda_gan * gen_gan_loss
  gen_loss = gen_gan_loss + kld_term + wc + depth_loss

  grads = _gradients(gen_loss, generator, state.data)
  grads = losses_lib.clip_grad_per_leaf(grads, hp.grad_clip_norm)
  gen_grad_norm = losses_lib.mean_leaf_norm(grads)
  _apply_gradients(state.g_opt, grads)

  disc_loss, dis_grad_norm = _update_discriminator(
      state, generated.detach(), depth_out.detach(), inputs, hp)
  update_ema(state.step, state.ema, generator, hp, params=state.g_opt.shards)

  zero = torch.zeros((), device=depth.device)
  return _global_metrics(state.data, {
      'dis/disc_loss': disc_loss,
      'dis/grad_norm': dis_grad_norm,
      'gen/gen_gan_loss': gen_gan_loss.detach(),
      'gen/gen_loss': gen_loss.detach(),
      'gen/depth_loss': depth_loss.detach(),
      'gen/seg_loss': zero,
      'gen/depth_seg_loss': zero,
      'gen/depth_seg_consistency': zero,
      'gen/kld_loss': kld_term.detach(),
      'gen/kld_nan': kld_nan_count,
      'gen/wc_loss': wc.detach(),
      'gen/grad_norm': gen_grad_norm,
  })


# The metric summed over the batch; the others are means.
_SUMMED_METRICS = ('gen/kld_nan',)


@torch.no_grad()
def _global_metrics(data: mesh.DataParallel,
                    metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
  """The metrics of the global batch: means over the ranks, sums for
  `_SUMMED_METRICS`."""
  if data.world_size == 1:
    return metrics
  values = torch.stack(list(metrics.values()))
  data.average([values])
  return {k: v * data.world_size if k in _SUMMED_METRICS else v
          for k, v in zip(metrics, values.unbind())}


@torch.no_grad()
def update_ema(step: int, ema: nn.Module, generator: nn.Module,
               hp: GANHParams,
               params: Optional[Sequence[torch.Tensor]] = None) -> None:
  """EMA of the generator's parameters and buffers (BatchNorm statistics,
  `u`), in place: assigned during the first `num_batched_steps` steps
  from `ema_init_step`, then ema - (ema - new) * (1 - decay). `params`:
  the generator's parameters as the EMA holds them (this rank's ZeRO-1
  shards, `Zero1Adam.shards`); all of them by default."""
  if step < hp.ema_init_step:
    return
  ema_tensors = [*ema.parameters(), *ema.buffers()]
  new_tensors = [*(generator.parameters() if params is None else params),
                 *generator.buffers()]
  with tracing.span('ema', timed=ema_tensors[0].is_cuda):
    if step < hp.ema_init_step + hp.num_batched_steps:
      torch._foreach_copy_(ema_tensors, new_tensors)
      return
    delta = torch._foreach_sub(ema_tensors, new_tensors)
    torch._foreach_mul_(delta, 1.0 - hp.ema_decay)
    torch._foreach_sub_(ema_tensors, delta)


def split_batch(batch: Dict[str, torch.Tensor], k: int
                ) -> List[Dict[str, torch.Tensor]]:
  """`k` equal chunks of every tensor along axis 0."""
  chunks = [{} for _ in range(k)]
  for key, value in batch.items():
    if value.shape[0] % k:
      raise ValueError(f'{key}: batch {value.shape[0]} does not split into '
                       f'{k} chunks')
    for chunk, part in zip(chunks, value.split(value.shape[0] // k)):
      chunk[key] = part
  return chunks


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               hp: GANHParams) -> Dict[str, torch.Tensor]:
  """One cluster element on an NHWC batch dict ('image', 'depth',
  'proj_image', 'proj_depth', 'proj_mask', 'blurred_mask'): split, (k-1)
  D steps and one G+D step, then step + 1. Returns the G+D metrics."""
  with tracing.span('train.step', timed=batch['image'].is_cuda):
    chunks = split_batch(batch, hp.d_step_per_g_step)
    for chunk in chunks[:-1]:
      train_d_step(state, chunk, hp)
    metrics = train_g_d_step(state, chunks[-1], hp)
    state.step += 1
  tracing.counter('train.steps')
  return metrics


def train_cluster(state: TrainState, batches: Dict[str, torch.Tensor],
                  hp: GANHParams) -> Dict[str, torch.Tensor]:
  """`train_step` over a stack of batches {k: (K, B, ...)}; the metrics
  averaged over the K steps."""
  num_steps = next(iter(batches.values())).shape[0]
  collected: Dict[str, list] = {}
  for i in range(num_steps):
    metrics = train_step(state, {k: v[i] for k, v in batches.items()}, hp)
    for k, v in metrics.items():
      collected.setdefault(k, []).append(v)
  return {k: torch.mean(torch.stack(v)) for k, v in collected.items()}


def state_differences(a: TrainState, b: TrainState,
                      grad_floor: float = 1e-3) -> Dict[str, float]:
  """Largest |a - b| of each part of two states of the same models, for
  parity checks.

  Adam moments (the first is 0.5 g after one step) are relative to the
  largest moment of the same kind in the model. Parameters (G, D, EMA)
  are compared only where b's first moment is at least `grad_floor` of
  the model's largest: Adam's first steps move a parameter by about
  lr * sign(g), so where a gradient is within its rounding error of 0 (a
  conv bias ahead of a BatchNorm, or any small gradient of an
  ill-conditioned model) the sign is noise. Keep `grad_floor` well above
  the moments' tolerance. The count of elements left out is 'excluded'
  (of 'compared' + 'excluded'). BatchNorm statistics ('*_stats'),
  power-iteration states ('*_u') and the Adam step counts are absolute.
  """
  out = {'excluded': 0, 'compared': 0}

  def note(key, value):
    value = value.detach() if torch.is_tensor(value) else value
    out[key] = max(out.get(key, 0.0), float(value))

  for part, (ma, mb, opt_a, opt_b, moments_of) in {
      'g': (a.generator, b.generator, a.g_opt, b.g_opt, b.generator),
      'd': (a.discriminator, b.discriminator, a.d_opt, b.d_opt,
            b.discriminator),
      'ema': (a.ema, b.ema, None, b.g_opt, b.generator)}.items():
    moments = {n: opt_b.state[p]['exp_avg']
               for n, p in moments_of.named_parameters()}
    floor = grad_floor * max(float(m.abs().max()) for m in moments.values())
    params_b = dict(mb.named_parameters())
    for name, pa in ma.named_parameters():
      keep = (moments[name].abs() >= floor).to(pa.device)
      out['compared'] += int(keep.sum())
      out['excluded'] += int((~keep).sum())
      note(f'{part}_params',
           ((pa - params_b[name].to(pa.device)).abs() * keep).max())
    buffers_b = dict(mb.named_buffers())
    for name, ta in ma.named_buffers():
      kind = 'u' if name.endswith('.u') else 'stats'
      note(f'{part}_{kind}',
           (ta - buffers_b[name].to(ta.device)).abs().max())
    if opt_a is None:
      continue
    params_a = dict(ma.named_parameters())
    for kind in ('exp_avg', 'exp_avg_sq'):
      pairs = [(opt_a.state[params_a[n]][kind], opt_b.state[p][kind])
               for n, p in params_b.items()]
      scale = max(float(tb.abs().max()) for _, tb in pairs)
      note(f'{part}_{kind}', max(float((ta - tb.to(ta.device)).abs().max())
                                 for ta, tb in pairs) / scale)
    note(f'{part}_adam_steps', max(
        abs(float(opt_a.state[params_a[n]]['step'])
            - float(opt_b.state[p]['step'])) for n, p in params_b.items()))
  return out
