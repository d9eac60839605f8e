"""Port parity for the serving slice with pole compaction.

The same comparison as test_torch_serving.py (whose helpers and stated
tolerances this file reuses), for `pole_compact=True` with
`mask_blurred=True`: the RGB cloud keeps only the rows that survive
`mask_pano`. One JAX model per file.
"""

import pytest

from test_torch_serving import assert_serving_close
from test_torch_serving import serve_both
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module')
def compacted_runs():
  return serve_both(dict(pole_compact=True), mask_blurred=True, seed=10)


def test_pole_compacted_serving_matches_jax(compacted_runs):
  assert_serving_close(compacted_runs)
