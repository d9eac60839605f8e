"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

FILES = sorted((ROOT / 'benchmark').rglob('*.py'))


def imported(path):
  names = set()
  for node in ast.walk(ast.parse(path.read_text())):
    if isinstance(node, ast.Import):
      names.update(a.name.split('.')[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      names.add(node.module.split('.')[0])
  return names


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
  assert not imported(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize(
    'path', sorted((ROOT / 'benchmark' / 'reference').rglob('*.py')),
    ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
  assert 'se3ds_torch' not in imported(path)


def test_names_are_compared_whole():
  import sys
  before = harness.forbidden_modules()
  sys.modules['se3ds_torch_probe'] = sys
  sys.modules['jaxtyping_probe'] = sys
  try:
    assert harness.forbidden_modules() == before
  finally:
    del sys.modules['se3ds_torch_probe'], sys.modules['jaxtyping_probe']
