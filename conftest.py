"""The harness of a whole test run: one JAX compilation cache per run, a time
limit on every test's call, and the units and order in which xdist hands the
tests of `tests/` to its workers.

`tests/conftest.py` sets up each process's devices; this file adds only what
a run of many tests needs, and writes nothing inside the repository.
"""

import collections
import faulthandler
import hashlib
import os
import shutil
import signal
import sys
import tempfile
import time

import pytest

# A test's call fails past this many seconds unless it carries its own
# @pytest.mark.timeout(n). The slowest calls of a whole run with 6 xdist
# workers on 8 cores take up to ~300 s with the compile cache, and a slower
# host up to ~1.4x that; ~3x would be more than the run's clock leaves.
DEFAULT_TIME_LIMIT = 600

# The JAX package's test files whose tests each build and compile programs
# of their own, beside which their module fixture, where there is one, is
# cheap. xdist's loadfile hands them out in units of UNIT_TESTS consecutive
# tests, which share more of their programs than tests far apart:
# test_inference.py and test_train.py took longer whole on one worker than
# the rest of the run, and test_geometry.py, with the most tests, went out
# last.
SPLIT_FILES = ('test_geometry.py', 'test_inference.py', 'test_train.py')
UNIT_TESTS = 3

# One directory per run, shared by its processes: the persistent
# compilation cache, and a file for each test call under way. Almost every
# test builds its own SE3DSModel(get_test_config()), whose jitted programs
# belong to the instance: without the cache each of them compiles the same
# HLO again.
_RUN_DIR = pytest.StashKey[str]()
_WORKER_RUN_DIR = 'se3ds_run_dir'


def pytest_configure(config):
  config.addinivalue_line(
      'markers', 'timeout(seconds): the time limit of the test\'s call, in '
      f'place of the default {DEFAULT_TIME_LIMIT} s')
  config.addinivalue_line(
      'markers', 'slow: a test that -m "not slow" leaves out')
  # tests/conftest.py has imported JAX by now where the run holds the JAX
  # package's tests; the benchmark's own tests never import it.
  jax = sys.modules.get('jax')
  workerinput = getattr(config, 'workerinput', None)
  if workerinput is None:
    # The controlling process (or a run without xdist): a fresh cache,
    # whatever JAX_COMPILATION_CACHE_DIR names, so that no run starts warm.
    run_dir = tempfile.mkdtemp(prefix='se3ds_tests_')
    config.stash[_RUN_DIR] = run_dir
    workers = getattr(config.option, 'numprocesses', None)
    if isinstance(workers, int) and workers > 1:
      _before_workers(workers, jax is not None)
  else:
    run_dir = workerinput[_WORKER_RUN_DIR]
  if jax is not None:
    jax.config.update('jax_compilation_cache_dir',
                      os.path.join(run_dir, 'jax_cache'))
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)
  config.pluginmanager.register(
      TimeLimit(DEFAULT_TIME_LIMIT, run_dir), 'time_limit')


def _before_workers(workers, jax_tests):
  # The workers' BLAS (scipy's sqrtm in every FID) and OpenMP (PyTorch)
  # pools, each as large as the cores, oversubscribe them and spin while
  # they wait: a 2048-d sqrtm takes 47 CPU-s on 8 threads and 29 on one.
  # XLA has no such setting.
  threads = str(max(1, len(os.sched_getaffinity(0)) // workers))
  for name in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS'):
    os.environ[name] = threads
  if jax_tests:
    # The JAX package's native loader builds its library in place at first
    # use, and test_native_loader.py asks for it while being collected: the
    # workers would race on one half-written file. Build it once, here.
    from se3ds_tpu.data import native_loader
    native_loader.available()


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
  """--dist loadfile, with SPLIT_FILES cut into units, the fewest tests first.

  xdist would hand out the units with the most tests first. Here the units
  with few tests are those whose tests build and train models (the GAN
  trainer's, the two-job protocol's, those of SPLIT_FILES), and they started
  last and ended long after the rest. Among units of as many tests, those of
  the smaller file go first: a whole file of few tests shares one fixture
  that takes long.
  """
  if config.getvalue('dist') != 'loadfile':
    return None
  from xdist.scheduler import LoadFileScheduling

  class Scheduling(LoadFileScheduling):

    def schedule(self):
      if not hasattr(self, 'units'):
        tests = next(iter(self.registered_collections.values()))
        self.file_tests = collections.Counter(
            nodeid.split('::', 1)[0] for nodeid in tests)
        self.units, place = {}, collections.Counter()
        for nodeid in tests:
          path = nodeid.split('::', 1)[0]
          if os.path.basename(path) in SPLIT_FILES:
            self.units[nodeid] = f'{path}::{place[path] // UNIT_TESTS}'
            place[path] += 1
      super().schedule()

    def _split_scope(self, nodeid):
      return self.units.get(nodeid) or super()._split_scope(nodeid)

    def _assign_work_unit(self, node):
      first = min(self.workqueue, key=lambda unit: (
          len(self.workqueue[unit]), self.file_tests[unit.split('::', 1)[0]]))
      self.workqueue.move_to_end(first, last=False)
      super()._assign_work_unit(node)

  return Scheduling(config, log)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
  """xdist: hands the controlling process's run directory to a worker."""
  node.workerinput[_WORKER_RUN_DIR] = node.config.stash[_RUN_DIR]


def pytest_unconfigure(config):
  if _RUN_DIR in config.stash:
    shutil.rmtree(config.stash[_RUN_DIR], ignore_errors=True)


class TimeLimit:
  """Fails a test whose call runs past its limit, and ends its process a
  minute later if the call never returns to Python (stuck in native code).

  xdist reports the test whose worker ended so as crashed and hands the
  rest of its unit to a new worker, that test included: a file in `run_dir`
  records each call under way, and a call that one has outlived fails at
  once instead of running again. A limit armed inside another (a run of
  pytest inside a test) gives the outer one back when it ends.
  """

  # The watchdogs armed in this process, innermost last: (deadline, fd).
  _watchdogs = []

  def __init__(self, default, run_dir):
    self.default = default
    self.run_dir = run_dir
    # faulthandler writes to a file descriptor, and stderr's own one is
    # redirected into the capture of the test that is running.
    self.stderr = os.dup(sys.__stderr__.fileno())

  def pytest_unconfigure(self, config):
    os.close(self.stderr)

  @pytest.hookimpl(wrapper=True)
  def pytest_runtest_call(self, item):
    marker = item.get_closest_marker('timeout')
    limit = marker.args[0] if marker else self.default
    started = os.path.join(
        self.run_dir, hashlib.sha1(item.nodeid.encode()).hexdigest())
    if os.path.exists(started):
      pytest.fail(f'{item.nodeid}: its process was ended {limit + 60} s '
                  'into this call; not run again', pytrace=False)

    def expire(signum, frame):
      pytest.fail(f'{item.nodeid}: over its {limit} s limit')

    open(started, 'w').close()
    watchdogs = TimeLimit._watchdogs
    begun = time.monotonic()
    previous = signal.signal(signal.SIGALRM, expire)
    outer, _ = signal.setitimer(signal.ITIMER_REAL, limit)
    watchdogs.append((begun + limit + 60, self.stderr))
    faulthandler.dump_traceback_later(limit + 60, exit=True, file=self.stderr)
    try:
      return (yield)
    finally:
      signal.setitimer(signal.ITIMER_REAL, 0)
      signal.signal(signal.SIGALRM, previous)
      if outer:
        # An outer limit that ran out meanwhile fires at once.
        elapsed = time.monotonic() - begun
        signal.setitimer(signal.ITIMER_REAL, max(outer - elapsed, 1e-3))
      watchdogs.pop()
      if watchdogs:
        deadline, fd = watchdogs[-1]
        faulthandler.dump_traceback_later(
            max(deadline - time.monotonic(), 1e-3), exit=True, file=fd)
      else:
        faulthandler.cancel_dump_traceback_later()
      os.remove(started)
