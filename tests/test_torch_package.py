"""The port's package rules: no JAX imports, and how its kernels build."""

import ast
import pathlib

import pytest

from se3ds_torch.ops import cuda_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'se3ds_tpu')
PORT_FILES = sorted((ROOT / 'se3ds_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']


def _imported_modules(tree):
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module
    elif (isinstance(node, ast.Call) and node.args
          and isinstance(node.args[0], ast.Constant)
          and isinstance(node.args[0].value, str)
          and getattr(node.func, 'attr', getattr(node.func, 'id', None))
          in ('import_module', '__import__')):
      yield node.args[0].value


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for module in _imported_modules(tree):
    assert module.split('.')[0] not in FORBIDDEN, (path, module)


def test_port_files_found():
  names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
  assert {'se3ds_torch/ops/splat_cuda.py', 'se3ds_torch/models/inference.py',
          'se3ds_torch/eval/metrics.py', 'se3ds_torch/eval/inception.py',
          'se3ds_torch/eval/fid.py', 'chip_smoke.py'} <= names


def test_kernel_build_flags():
  """sm_90a, IEEE division and no FMA contraction (the kernel's floats
  round like the plain version's), never fast math."""
  flags = ' '.join(cuda_build.NVCC_FLAGS)
  assert 'arch=compute_90a,code=sm_90a' in flags
  assert '-fmad=false' in flags
  assert 'fast_math' not in flags and 'prec-div=false' not in flags
  assert cuda_build.sources() == ['splat.cu', 'splat_exact.cu']


def test_library_name_follows_the_source():
  path = cuda_build.library_path('splat.cu')
  assert path.parent == cuda_build.BUILD_DIR
  assert path.name.startswith('libsplat_') and path.suffix == '.so'
  assert path == cuda_build.library_path('splat.cu')


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
  """An edit to a csrc/*.cuh header renames (so rebuilds) every library."""
  for name in ('a.cu', 'pixel.cuh'):
    (tmp_path / name).write_text(name)
  monkeypatch.setattr(cuda_build, 'CSRC_DIR', tmp_path)
  before = cuda_build.library_path('a.cu')
  (tmp_path / 'pixel.cuh').write_text('edited')
  assert cuda_build.library_path('a.cu') != before
