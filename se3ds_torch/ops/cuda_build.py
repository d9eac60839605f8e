"""Builds the port's CUDA sources into shared libraries at first use.

Each `csrc/*.cu` file exposes a plain C interface and is compiled by
`nvcc` into its own shared library, loaded with `ctypes`. The library name
carries a hash of the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. Libraries go to `build/se3ds_torch/` at
the root of the checkout (listed in .gitignore). `build()` starts one
`nvcc` per source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'se3ds_torch'

# sm_90a (Hopper), with nvcc's default -fmad=true, as PyTorch's own CUDA
# kernels are built, so the math library's atan2f and acosf give the
# bits of PyTorch's. The sources write every other float operation with
# round-to-nearest intrinsics, which are never fused, so each rounds like
# the separate PyTorch op of the plain version (csrc/pixel.cuh).
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xptxas=-v', '-shared', '-Xcompiler', '-fPIC')

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
  """Names of every CUDA source of the port."""
  return sorted(p.name for p in CSRC_DIR.glob('*.cu'))


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  default = '/usr/local/cuda/bin/nvcc'
  if os.path.exists(default):
    return default
  raise RuntimeError('nvcc not found: the CUDA kernels of se3ds_torch are '
                     'built from source on the machine with the card.')


def library_path(name: str) -> Path:
  """Where the library built from csrc/<name> lives."""
  digest = hashlib.sha1((CSRC_DIR / name).read_bytes())
  for header in sorted(CSRC_DIR.glob('*.cuh')):
    digest.update(header.read_bytes())
  digest.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'lib{Path(name).stem}_{digest.hexdigest()[:16]}.so'


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
  """Compiles each named source (default: all) whose library is missing.

  The compilations run in parallel. The compiler's output (register and
  shared-memory use from -Xptxas=-v) is kept beside each library as
  `<library>.log`. Raises RuntimeError naming the source on failure.
  """
  names = sources() if names is None else list(names)
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  paths = {name: library_path(name) for name in names}
  running = []
  for name, out in paths.items():
    if out.exists():
      continue
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    running.append((name, out, tmp, proc))
  failures = []
  for name, out, tmp, proc in running:
    log, _ = proc.communicate()
    out.with_name(out.name + '.log').write_text(log)
    if proc.returncode != 0:
      failures.append(f'{name}:\n{log}')
      continue
    os.replace(tmp, out)
  if failures:
    raise RuntimeError('nvcc failed for ' + '\n'.join(failures))
  return paths


def load(name: str) -> ctypes.CDLL:
  """The library built from csrc/<name>, built first if needed."""
  if name not in _LOADED:
    _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
  return _LOADED[name]
