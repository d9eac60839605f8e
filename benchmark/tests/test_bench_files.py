"""BENCHMARK.json keeps to its contract, and the harness finds a cell's
configuration, traffic, limits, driver and metric readers from files
alone."""

import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())


def test_names_and_units_use_allowed_characters():
  names = [c['name'] for c in SPEC['configs']]
  names += [w['name'] for w in SPEC['workloads']]
  names += [w['traffic'] for w in SPEC['workloads']]
  names += [k for c in SPEC['configs'] for k in c['reduced']]
  metrics = SPEC['end_to_end'] + SPEC['per_layer']
  names += [m['name'] for m in metrics]
  assert all(NAME.match(n) for n in names), names
  assert all(UNIT.match(m['unit']) for m in metrics)
  assert len({m['name'] for m in metrics}) == len(metrics)
  assert len({w['name'] for w in SPEC['workloads']}) == len(SPEC['workloads'])


def test_contract_keys_and_bounds():
  assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                       'workloads', 'end_to_end', 'per_layer'}
  assert 1 <= SPEC['run_seconds'] <= 51
  for metric in SPEC['end_to_end']:
    assert 0.01 <= metric['bound'] <= 0.25
    assert metric['source'] in ('host_clock', 'device_trace')
  reported = {}
  for metric in SPEC['end_to_end']:
    for cell in metric.get('workloads', [w['name'] for w in SPEC['workloads']]):
      reported.setdefault(cell, set()).add(metric['name'])
  for metric in SPEC['per_layer']:
    for cell in metric['workloads']:
      assert metric['moves'] in reported[cell]
  for cell in SPEC['workloads']:
    assert 'setup_s' in reported[cell['name']]
    assert len(reported[cell['name']]) >= 2
    assert any(cell['name'] in m['workloads'] for m in SPEC['per_layer'])
  assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize('name', [w['name'] for w in SPEC['workloads']])
def test_every_cell_resolves_to_its_files(name):
  cell = harness.find_cell(name)
  assert harness.driver(cell).run
  for metric in cell.per_layer:
    assert callable(harness.reader(metric['name']))
  assert cell.limits


def test_a_cell_added_as_files_is_found(tmp_path):
  """A later PR adds a cell as files and entries only."""
  shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
  bench = tmp_path / 'benchmark'
  shutil.copytree(ROOT / 'benchmark', bench,
                  ignore=shutil.ignore_patterns('__pycache__'))
  spec = json.loads((tmp_path / 'BENCHMARK.json').read_text())
  spec['configs'].append(dict(spec['configs'][0], name='dummy-config',
                              file='benchmark/configs/dummy-config.json'))
  spec['workloads'].append({'name': 'dummy-cell', 'config': 'dummy-config',
                            'traffic': 'dummy-traffic', 'chips': 1,
                            'why': 'a test'})
  spec['per_layer'].append({'name': 'dummy.metric', 'unit': 'ms',
                            'better': 'lower', 'source': 'program_span',
                            'layer': 'serving API and capture',
                            'moves': 'setup_s', 'workloads': ['dummy-cell']})
  (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))
  shutil.copy(bench / 'configs' / 'se3ds-mp3d-serve.json',
              bench / 'configs' / 'dummy-config.json')
  (bench / 'traffic' / 'dummy-traffic.json').write_text(
      json.dumps({'driver': 'serve_poses', 'poses_per_call': 2}))
  (bench / 'workloads' / 'dummy-cell.json').write_text(
      json.dumps({'limits': {'rgb_mae': 1.0}}))
  (bench / 'metrics' / 'dummy.metric.py').write_text(
      'def read(record):\n  return 42.0\n')
  cell = harness.find_cell('dummy-cell', root=tmp_path, bench=bench)
  assert cell.traffic['poses_per_call'] == 2
  assert cell.limits == {'rgb_mae': 1.0}
  assert [m['name'] for m in cell.per_layer] == ['dummy.metric']
  assert {m['name'] for m in cell.end_to_end} == {'setup_s'}
  assert harness.reader('dummy.metric', bench=bench)(None) == 42.0
