"""A trajectory served frame by frame from a ring memory, one call at a time.

The traffic of trajectory and video synthesis, and of an agent walking a
scene: one seeded room panorama is added at the origin, then a closed
loop of `model(position, add_preds_to_memory=True)` calls along a seeded
closed path, each call starting when the one before has ended (each
prediction is written back into the ring memory, which the next step
reads). A call ends when its `pred_rgb` and `pred_depth` are on the
host, where a trajectory user writes them out; its latency runs from its
start.

Set-up warms up until the ring is full and the step's graph replays.
The correctness check follows the program step by step: for each
sampled step the reference rebuilds the memory from the panorama and the
served outputs of the steps before it (the frames the program wrote),
splats it and runs the generator; the first step, whose memory is the
panorama alone, is always compared, and so is the last. After the
window, the program's memory is held to the reference's unprojection of
the last frames written, slot by slot.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness
from benchmark import traffic
from benchmark import trace as trace_lib
from benchmark.drivers import serving
from benchmark.reference import flops as ref_flops


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float, control: bool = False) -> harness.Outcome:
  from se3ds_torch.models import inference

  p = cell.traffic
  cfg = serving.se3ds_config(cell, memory_mode='ring')
  height, frames_cap = cfg.image_height, cfg.memory_frames
  pano = traffic.synthetic_pano(height, traffic.rng(seed, 'scene'))
  origin = np.zeros((1, 3), np.float32)
  path = traffic.closed_loop(traffic.rng(seed, 'path'), p['path_points'],
                             p['radius_m'])
  first = pano + (origin,)
  setup = serving.Setup(cell, seed, device, [first], [first], path[:1])
  harness.log(started, 'weights made')
  harness.reset_peak(device)
  model = inference.SE3DSModel(cfg, variables=setup.host.numpy_tree(),
                               device=device)
  model.add_to_memory(*pano, origin)
  harness.log(started, 'program built')

  writes = {0: first}  # write index -> what it held, while a check needs it
  kept = {}            # step -> the program's OutputData, for the check
  keep = traffic.sampled(seed, p['max_steps'], p['sample_every'])
  spans = harness.Spans()
  no_semantics = np.zeros((1, height, 2 * height, 1), np.int32)

  def step(g: int, timed: bool, traced: bool = False):
    position = path[g % len(path)][None]
    with spans.span('call' if timed else 'other'), harness.mark(
        'bench.call', traced):
      out = model(position, add_preds_to_memory=True)
    with harness.mark('bench.to_host', traced):
      rgb, depth = out.pred_rgb.cpu().numpy(), out.pred_depth.cpu().numpy()
    writes[g + 1] = (rgb, no_semantics, depth, position)
    # A write that no step from here on reads is dropped unless a kept
    # step read it: the host keeps only what the check needs.
    gone = g - frames_cap
    if gone > 0 and not any(s in kept for s in range(gone, g)):
      del writes[gone]
    if g == 0 or (timed and g < len(keep) and keep[g]):
      kept[g] = out
    return out

  for g in range(p['warmup_steps']):
    step(g, timed=False)
  harness.sync(device)
  harness.log(started, 'warmed up')
  w0 = time.perf_counter()
  g, latencies = p['warmup_steps'], []
  while True:
    t0 = time.perf_counter()
    out = step(g, timed=True)
    t1 = time.perf_counter()
    latencies.append(t1 - t0)
    g += 1
    if t1 - w0 >= seconds:
      break
  kept[g - 1] = out
  window_s = t1 - w0
  steps = len(latencies)
  harness.log(started, f'window: {steps} steps in {window_s:.3f} s')
  summary = None
  if trace:
    upcoming = iter(range(g, g + p['trace_warmup'] + p['trace_steps']))
    summary = trace_lib.traced(
        lambda: step(next(upcoming), timed=False, traced=True),
        p['trace_warmup'], p['trace_steps'])
    spans.counters['panos_traced'] = p['trace_steps']
    spans.counters['calls_traced'] = p['trace_steps']
    harness.log(started, 'traced')
  spans.counters['flops_per_pano'] = ref_flops.served_pano(
      cfg.gen_dims, cfg.resnet_version, height, cfg.use_blurred_mask)
  spans.counters['splat_clouds'] = splat_clouds(cfg)
  memory_peak = harness.peak_bytes(device)
  state = model.get_memory_state()
  del model
  harness.release(device)

  comparison = serving.Comparison(setup, device, control=control)
  for s in sorted(kept):
    live = [writes[i] for i in range(max(0, s + 1 - frames_cap), s + 1)]
    frames = [comparison.frame(w) for w in live]
    sem = [f for f, w in zip(frames, live) if w is first]
    comparison.call(frames, sem, path[s % len(path)][None], kept[s])
  written = max(writes) + 1
  last = {(written - 1 - i) % frames_cap: writes[written - 1 - i]
          for i in range(min(frames_cap, written))}
  comparison.memory(state, {slot: comparison.frame(w)
                            for slot, w in last.items()})
  harness.log(started, f'compared {comparison.compared} steps')

  ordered = sorted(latencies)
  rank = lambda q: ordered[int(np.ceil(q * len(ordered))) - 1]
  end_to_end = {'serve_panos_per_s': steps / window_s,
                'serve_step_ms_p95': rank(0.95) * 1e3,
                'setup_s': w0 - started}
  return harness.Outcome(
      end_to_end, harness.Record(cell, spans, summary),
      serving.checks(comparison, cell.limits), attempted=steps, failed=0,
      memory_peak_bytes=memory_peak,
      readings={'program': dict(comparison.readings),
                'control': dict(comparison.control_readings),
                'compared': comparison.compared})


def splat_clouds(cfg):
  """The clouds a step of a full ring must read: the RGB cloud of every
  frame (the pole rows dropped), and no semantic points (the predicted
  frames hold none once the panorama has left the ring); one guidance
  plane of each."""
  from benchmark.reference import geometry as ref_geo
  h, w = cfg.image_height, 2 * cfg.image_height
  r0, r1 = ref_geo.pole_valid_rows(h) if cfg.pole_compact else (0, h)
  return [dict(points=cfg.memory_frames * (r1 - r0) * w, channels=3,
               depth=True, planes=1, pixels=h * w),
          dict(points=0, channels=1, depth=False, planes=1, pixels=h * w)]

