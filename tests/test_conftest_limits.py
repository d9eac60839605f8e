"""The time limit that the repository's root conftest.py puts on every
test's call."""

import hashlib
import signal

import pytest

pytest_plugins = ['pytester']


@pytest.fixture
def time_limit(request, pytester):
  """A new TimeLimit, as this run's own, over a directory of its own."""
  limit_type = type(request.config.pluginmanager.get_plugin('time_limit'))
  run_dir = pytester.mkdir('run')
  return limit_type(600, str(run_dir)), run_dir


def test_call_over_its_limit_fails_and_the_run_goes_on(pytester, time_limit):
  pytester.makepyfile("""
      import time
      import pytest

      @pytest.mark.timeout(2)
      def test_sleeps_past_its_limit():
        time.sleep(30)

      def test_after_it():
        pass
  """)
  limit, _ = time_limit
  result = pytester.runpytest(plugins=[limit])
  result.assert_outcomes(failed=1, passed=1)
  result.stdout.fnmatch_lines(
      ['*test_sleeps_past_its_limit: over its 2 s limit*'])


def test_call_under_its_limit_passes_and_disarms(pytester, time_limit):
  """The inner run's limit is gone after it, and this test's own limit, the
  outer one, still runs."""
  pytester.makepyfile("""
      import pytest

      @pytest.mark.timeout(2)
      def test_quick():
        pass
  """)
  limit, run_dir = time_limit
  handler = signal.getsignal(signal.SIGALRM)
  outer, _ = signal.getitimer(signal.ITIMER_REAL)
  result = pytester.runpytest(plugins=[limit])
  result.assert_outcomes(passed=1)
  left, _ = signal.getitimer(signal.ITIMER_REAL)
  assert 0 < outer - 10 < left <= outer
  assert signal.getsignal(signal.SIGALRM) is handler
  assert not list(run_dir.iterdir())


def test_call_whose_process_was_ended_is_not_run_again(pytester, time_limit):
  """A call left under way by a process that its limit ended fails at once
  when xdist hands it to the next worker."""
  test_file = pytester.makepyfile("""
      import time

      def test_hangs():
        time.sleep(30)
  """)
  limit, run_dir = time_limit
  nodeid = f'{test_file.name}::test_hangs'
  (run_dir / hashlib.sha1(nodeid.encode()).hexdigest()).touch()
  result = pytester.runpytest(plugins=[limit])
  result.assert_outcomes(failed=1)
  result.stdout.fnmatch_lines(
      ['*test_hangs: its process was ended 660 s into this call*'])
