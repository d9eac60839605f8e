"""Port parity for bf16 serving (`compute_dtype='bfloat16'`).

The comparison of test_torch_serving.py (its helpers), at
`get_test_config()` with `pole_compact=False`, add_to_memory and two
`add_preds_to_memory=True` steps, in bf16 in both packages. The two
round to bf16 at different places (XLA fuses the casts into its convs;
PyTorch casts each conv's input and output), so the generator's outputs
agree only within a band, which the band of each package against its
own float32 run matches (JAX bf16 against JAX float32: 2 levels on 19%
of values, pred_depth 0.0081; the port's: 2 levels on 20-21%, 0.0143).

The band is a property of the weights: these are serve_both's default
seed-0 weights, on which the band was measured. On weights with larger
gains bf16 moves each package further from its own float32 run (weight
seed 20: JAX bf16 27 levels off JAX float32 at the second step, the
port's 24), and the two packages' bf16 runs drift apart as far.

Tolerances (measured here: pred_rgb 2 levels on 22-24% of values,
pred_depth 0.0107):
* pred_rgb at most BF16_RGB_LEVELS (2) levels of 255 off, on at most
  BF16_RGB_SHARE (25%) of values;
* pred_depth within BF16_DEPTH_ATOL (0.015);
* guidance (proj_rgb, proj_semantic, proj_mask) and mu equal (measured:
  equal at both steps), proj_depth within 1e-6 (XLA divides the depth
  by depth_scale as a multiply by the reciprocal; measured 6e-8).
"""

import numpy as np
import pytest

from test_torch_serving import serve_both
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

BF16_RGB_LEVELS = 2
BF16_RGB_SHARE = 0.25
BF16_DEPTH_ATOL = 0.015


@pytest.fixture(scope='module')
def bf16_runs():
  return serve_both(dict(pole_compact=False, compute_dtype='bfloat16'),
                    mask_blurred=False)


def test_bf16_serving_within_the_band_of_jax(bf16_runs):
  for step, (ref, got) in enumerate(zip(*bf16_runs)):
    assert ref.keys() == got.keys()
    for key in ref:
      assert got[key].shape == ref[key].shape, key
      assert got[key].dtype == ref[key].dtype, key
    rgb_err = np.abs(got['pred_rgb'].astype(int) - ref['pred_rgb'])
    assert rgb_err.max() <= BF16_RGB_LEVELS, (step, rgb_err.max())
    assert (rgb_err > 0).mean() <= BF16_RGB_SHARE, (step, (rgb_err > 0).mean())
    np.testing.assert_allclose(got['pred_depth'], ref['pred_depth'], rtol=0,
                               atol=BF16_DEPTH_ATOL)
    for key in ('proj_rgb', 'proj_semantic', 'proj_mask', 'mu',
                'pred_semantic'):
      np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got['proj_depth'], ref['proj_depth'], rtol=0,
                               atol=1e-6)
    assert 0 < ref['proj_mask'].mean() < 1
