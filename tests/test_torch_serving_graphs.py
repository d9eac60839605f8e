"""How the port's serving API runs as programs (`SE3DSModel` with
`models/graphs.py`), on the CPU.

On the card each call replays a captured CUDA graph keyed as the JAX
package keys its compiled programs; here the model runs eagerly and the
tests hold what the graphs rely on:

* the bucketed extents (frame and semantic extents rounded up to powers
  of two) give outputs equal to the port's exact extents, bit for bit
  (the extra slots are void and the splat skips them), and close to the
  JAX model, which buckets the same way, over steps that cross a bucket
  and a ring wrap (tolerances: `assert_serving_close` of
  test_torch_serving.py, for the unprojection's trig);
* the memory buffers and the previous frame keep their addresses through
  every entry point;
* a returned OutputData is the caller's: later calls, and a replay
  overwriting a graph's outputs, leave it as it was;
* the number of programs, counted through a stand-in for
  `torch.cuda.graph` that records captures without a card.

The card tests (graph against eager, torch.equal; the launch counters on
replay) are in test_torch_cuda.py.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from se3ds_torch import tracing
from se3ds_torch.models import graphs
from se3ds_torch.models import inference as inference_t
from se3ds_torch.models import model_config as config_t
from se3ds_torch.ops import geometry as geometry_t
from se3ds_tpu.models import inference as inference_j
from se3ds_tpu.models import model_config as config_j
from test_torch_serving import assert_serving_close
from test_torch_serving import random_flax_variables
from test_torch_serving import random_pano
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

ORIGIN = np.zeros((1, 3), np.float32)
POSES = np.array([[0.3, 0.1, 0.0], [-0.2, 0.25, 0.05]], np.float32)


def _position(i):
  return np.array([[0.25 * i, -0.1 * i, 0.02 * i]], np.float32)


def _numpy(out):
  return {k: np.asarray(v) for k, v in out._asdict().items()
          if v is not None}


def _equal(a, b):
  for x, y in zip(a, b):
    if x is not None:
      assert torch.equal(x, y)


def _port(variables=None, **overrides):
  cfg = dataclasses.replace(config_t.get_test_config(), **overrides)
  if variables is not None:
    return inference_t.SE3DSModel(cfg, variables=variables, device='cpu')
  return inference_t.SE3DSModel(cfg, device='cpu',
                                generator=torch.Generator().manual_seed(0))


def _exact_extents(model):
  """The model with the exact live extents of the port before it
  bucketed them."""
  model._frame_bucket = lambda: max(1, model._frames_written)
  model._sem_bucket = model._sem_frames_live
  return model


def _ring_sequence(model, panos):
  """Three observations, a step that splats 3 frames in a bucket of 4
  (semantic extent 3 in a bucket of 4 too), a step that wraps onto slot
  0, then a read-only call; numpy outputs of the last three."""
  for i, pano in enumerate(panos):
    model.add_to_memory(*pano, _position(i))
  outs = [model(_position(3), add_preds_to_memory=True),
          model(_position(4), add_preds_to_memory=True),
          model(_position(5))]
  return [_numpy(o) for o in outs]


def test_bucketed_extents_equal_exact_ones_and_jax():
  variables = random_flax_variables(config_j.get_test_config(), 0)
  panos = [random_pano(32, 30 + i) for i in range(3)]
  overrides = dict(memory_mode='ring', memory_frames=4)
  bucketed = _port(variables, **overrides)
  exact = _exact_extents(_port(variables, **overrides))
  got = _ring_sequence(bucketed, panos)
  assert (bucketed._frame_bucket(), bucketed._sem_bucket()) == (4, 4)
  want = _ring_sequence(exact, panos)
  assert (exact._frame_bucket(), exact._sem_bucket()) == (4, 3)
  for g, w in zip(got, want):
    for k in w:
      np.testing.assert_array_equal(g[k], w[k], err_msg=k)
  # predict_poses and a trajectory (whose extents stay exact) after it.
  _equal(bucketed.predict_poses(POSES), exact.predict_poses(POSES))
  _equal(bucketed.predict_trajectory(POSES), exact.predict_trajectory(POSES))

  cfg_j = dataclasses.replace(config_j.get_test_config(), **overrides)
  jax_model = inference_j.SE3DSModel(cfg_j, variables=variables)
  assert_serving_close((_ring_sequence(jax_model, panos), got))


def _state_ptrs(model):
  memory = model.get_memory_state(copy=False)
  return [t.data_ptr() for t in memory[:4]] + [
      model.prev_rgb_frame.data_ptr()]


def test_state_keeps_its_addresses():
  model = _port(memory_mode='ring', memory_frames=4)
  ptrs = _state_ptrs(model)
  pano = random_pano(32, 40)
  model.add_to_memory(*pano, ORIGIN)
  saved = model.get_memory_state()
  read = model(_position(1))
  first_step = model(_position(2), add_preds_to_memory=True)
  model.predict_trajectory(np.concatenate([_position(3), _position(4)]))
  model.predict_poses(POSES)
  assert _state_ptrs(model) == ptrs
  model.set_memory_state(saved)
  assert _state_ptrs(model) == ptrs
  _equal(model(_position(1)), read)
  model.reset_memory()
  assert _state_ptrs(model) == ptrs
  model.add_to_memory(*pano, ORIGIN)
  _equal(model(_position(2), add_preds_to_memory=True), first_step)
  assert _state_ptrs(model) == ptrs


def test_memory_layout_is_checked_on_restore():
  model = _port()
  state = model.get_memory_state()
  with pytest.raises(ValueError, match='coords'):
    model.set_memory_state(state._replace(coords=state.coords[:, :, :5]))


def test_write_slot_is_checked_on_the_host():
  """The programs write at a device scalar, which the device does not
  bound-check: `SE3DSModel` refuses a slot outside the memory first."""
  model = _port(memory_frames=4)
  assert int(model._slot(3)) == 3
  for slot in (-1, 4):
    with pytest.raises(ValueError, match='outside the memory'):
      model._slot(slot)


class _StubGraph:
  """Stands in for torch.cuda.CUDAGraph: replay runs nothing."""

  def replay(self):
    pass


def _stub_programs(captured):
  """A `graphs.Programs` whose capture only counts (the captured function
  runs eagerly under the stand-in)."""

  def capture(graph, pool):
    assert pool == ('stub', 0)
    captured.append(graph)
    return contextlib.nullcontext()

  return graphs.Programs(capture=capture, new_graph=_StubGraph,
                         pool=('stub', 0))


def test_outputs_belong_to_the_caller():
  model = _port()
  model.add_to_memory(*random_pano(32, 41), ORIGIN)
  eager = model(_position(1))
  kept = [t.clone() for t in eager if t is not None]
  model.graphs = _stub_programs([])
  replays = tracing.count('serve.replays')
  model(_position(1))  # warms the key up
  captured = model(_position(2))  # captures, replays, copies out
  kept_captured = [t.clone() for t in captured if t is not None]
  (entry,) = model.graphs.graphs.values()
  for value in entry.outputs.values():  # what a replay does to them
    value.fill_(7)
  replayed = model(_position(3))
  assert torch.equal(replayed.pred_rgb,
                     torch.full_like(replayed.pred_rgb, 7))
  _equal([t for t in captured if t is not None], kept_captured)
  _equal([t for t in eager if t is not None], kept)
  assert tracing.count('serve.replays') - replays == 2


def _kinds(programs, kind):
  return [k for k in programs.warmed if k[0][0] == kind]


@pytest.mark.parametrize('memory_mode', ['strict', 'ring'])
def test_program_keys_are_bounded(memory_mode):
  """Read-only and step programs per frame bucket, counted with the
  stand-in capture: the usual flow (one observation, then predictions)
  holds at most L = log2(memory_frames) + 1 read-only programs and L step
  programs (2L with use_projected_rgb); the write slot adds none, before
  or after a ring wrap; a key's second call captures it."""
  frames = 8
  levels = int(math.log2(frames)) + 1
  model = _port(memory_mode=memory_mode, memory_frames=frames)
  captured = []
  model.graphs = _stub_programs(captured)
  model.add_to_memory(*random_pano(32, 42), ORIGIN)
  steps = frames - 1 if memory_mode == 'strict' else 2 * frames + 3
  for i in range(steps):
    model(_position(i))
    model(_position(i) + 0.01)
    model(_position(i), add_preds_to_memory=True,
          use_projected_rgb=(i % 2 == 1))
  reads, step_keys = _kinds(model.graphs, 'call'), _kinds(model.graphs,
                                                          'step')
  assert len(reads) == levels
  assert len(step_keys) <= 2 * levels
  assert {k[0][1] for k in reads} == {1, 2, 4, 8}
  assert {k[0][2] for k in reads + step_keys} == {1}
  # Every read-only key ran at least twice: each is a captured graph.
  assert set(reads) <= set(model.graphs.graphs)
  assert len(captured) == len(model.graphs.graphs)
  if memory_mode == 'ring':
    assert model._total_frames == steps + 1
    before = set(model.graphs.warmed)
    for i in range(frames):  # every slot again: no new key
      model(_position(i), add_preds_to_memory=True,
            use_projected_rgb=(i % 2 == 1))
    assert set(model.graphs.warmed) == before


def test_program_keys_when_observations_interleave():
  """Observations between predictions move the semantic bucket too:
  read-only programs stay within L(L+1)/2, the pairs of a frame bucket
  and a semantic bucket no larger than it."""
  frames = 8
  levels = int(math.log2(frames)) + 1
  model = _port(memory_frames=frames)
  model.graphs = _stub_programs([])
  pano = random_pano(32, 43)
  for i in range(frames // 2):
    model.add_to_memory(*pano, _position(i))
    model(_position(i))
    model(_position(i), add_preds_to_memory=True)
  reads = _kinds(model.graphs, 'call')
  assert len(reads) <= levels * (levels + 1) // 2
  assert all(k[0][2] <= k[0][1] for k in reads)


def test_graphs_are_chosen_at_construction():
  """The CPU runs eagerly whatever `cuda_graphs` says, and says why."""
  for flag in (True, False):
    model = inference_t.SE3DSModel(config_t.get_test_config(), device='cpu',
                                   cuda_graphs=flag)
    assert model.graphs is None
    assert model.uncaptured == 'the CPU runs eagerly'


def _linspace_numpy(start, stop, num):
  start32, stop32 = np.float32(start), np.float32(stop)
  if num == 1:
    return np.array([start32], np.float32)
  t = np.arange(num, dtype=np.float32) / np.float32(num - 1)
  out = (start32 * (np.float32(1) - t) + stop32 * t).astype(np.float32)
  out[-1] = stop32
  return out


@pytest.mark.parametrize('height', [1, 2, 32, 128, 512])
def test_unprojection_grid_is_numpys_linspace(height):
  """The unprojection's grids are computed on the tensors' device (a
  captured graph holds no host copy); their bits are numpy's float32
  linspace, as before."""
  half = 0.5 * math.pi / height
  for args in ((half, math.pi - half, height),
               (1.5 * math.pi - half, -0.5 * math.pi + half, 2 * height)):
    got = geometry_t._linspace_f32(*args, torch.device('cpu')).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _linspace_numpy(*args).view(np.int32))
