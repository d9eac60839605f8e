"""Many candidate views rendered from one scene memory (VLN augmentation).

A strict memory is filled with seeded room panoramas at seeded
positions; then a closed loop of `predict_poses` calls, each of K seeded
positions, one call at a time. A call ends when its K panoramas
(`pred_rgb`, `pred_depth`) are on the host. The memory is never
written in the window.

The correctness check runs the reference on sampled calls (and the last)
from the panoramas themselves: its own unprojection, its splat at each
of the K positions, its generator. After the window the program's memory
is held to the reference's unprojection of the panoramas.
"""

from __future__ import annotations

import time

from benchmark import harness
from benchmark import traffic
from benchmark import trace as trace_lib
from benchmark.drivers import serving
from benchmark.reference import flops as ref_flops
from benchmark.reference import geometry as ref_geo


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float, control: bool = False) -> harness.Outcome:
  from se3ds_torch.models import inference

  p = cell.traffic
  cfg = serving.se3ds_config(cell, memory_mode='strict')
  height, k = cfg.image_height, p['poses_per_call']
  scene = traffic.rng(seed, 'scene')
  where = traffic.in_disc(traffic.rng(seed, 'panos'), cfg.memory_frames,
                          p['pano_spread_m'])
  writes = [traffic.synthetic_pano(height, scene) + (where[i][None],)
            for i in range(cfg.memory_frames)]
  draw = traffic.rng(seed, 'poses')
  calls = [traffic.in_disc(draw, k, p['pose_spread_m'])
           for _ in range(p['distinct_calls'])]
  setup = serving.Setup(cell, seed, device, writes, writes, calls[0][:1])
  harness.log(started, 'weights made')
  harness.reset_peak(device)
  model = inference.SE3DSModel(cfg, variables=setup.host.numpy_tree(),
                               device=device)
  for rgb, sem, depth, position in writes:
    model.add_to_memory(rgb, sem, depth, position)
  harness.log(started, 'program built')

  kept = {}
  keep = traffic.sampled(seed, p['max_calls'], p['sample_every'])
  spans = harness.Spans()

  def call(i: int, timed: bool, traced: bool = False):
    with spans.span('call' if timed else 'other'), harness.mark(
        'bench.call', traced):
      out = model.predict_poses(calls[i % len(calls)])
    with harness.mark('bench.to_host', traced):
      out.pred_rgb.cpu().numpy(), out.pred_depth.cpu().numpy()
    if timed and i < len(keep) and keep[i]:
      kept[i] = out
    return out

  for i in range(p['warmup_calls']):
    call(i, timed=False)
  harness.sync(device)
  harness.log(started, 'warmed up')
  w0 = time.perf_counter()
  i = p['warmup_calls']
  while True:
    out = call(i, timed=True)
    t1 = time.perf_counter()
    i += 1
    if t1 - w0 >= seconds:
      break
  kept[i - 1] = out
  window_s = t1 - w0
  n_calls = len(spans.wall['call'])
  harness.log(started, f'window: {n_calls} calls in {window_s:.3f} s')

  summary = None
  if trace:
    upcoming = iter(range(i, i + p['trace_warmup'] + p['trace_calls']))
    summary = trace_lib.traced(
        lambda: call(next(upcoming), timed=False, traced=True),
        p['trace_warmup'], p['trace_calls'])
    harness.log(started, 'traced')
    spans.counters['panos_traced'] = p['trace_calls'] * k
    spans.counters['calls_traced'] = p['trace_calls']
  spans.counters['flops_per_pano'] = ref_flops.served_pano(
      cfg.gen_dims, cfg.resnet_version, height, cfg.use_blurred_mask)
  spans.counters['splat_clouds'] = splat_clouds(cfg, k)
  memory_peak = harness.peak_bytes(device)
  state = model.get_memory_state()
  del model
  harness.release(device)

  comparison = serving.Comparison(setup, device, control=control)
  frames = [comparison.frame(w) for w in writes]
  for j in sorted(kept):
    comparison.call(frames, frames, calls[j % len(calls)], kept[j])
  comparison.memory(state, dict(enumerate(frames)))
  harness.log(started, f'compared {comparison.compared} calls')

  end_to_end = {'serve_panos_per_s': n_calls * k / window_s,
                'setup_s': w0 - started}
  return harness.Outcome(
      end_to_end, harness.Record(cell, spans, summary),
      serving.checks(comparison, cell.limits), attempted=n_calls * k,
      failed=0, memory_peak_bytes=memory_peak,
      readings={'program': dict(comparison.readings),
                'control': dict(comparison.control_readings),
                'compared': comparison.compared})


def splat_clouds(cfg, k: int):
  """What one call of K views must read and write: each cloud's points
  once (the K views share the memory), K guidance planes of each."""
  h, w = cfg.image_height, 2 * cfg.image_height
  r0, r1 = ref_geo.pole_valid_rows(h) if cfg.pole_compact else (0, h)
  return [dict(points=cfg.memory_frames * (r1 - r0) * w, channels=3,
               depth=True, planes=k, pixels=h * w),
          dict(points=cfg.memory_frames * h * w, channels=1, depth=False,
               planes=k, pixels=h * w)]

