"""The port's VLN perturbation check against JAX's, and the port's three
demos end to end on the CPU.

`sample_perturbed_views` is held to JAX's in test_torch_serving_api.py,
where it reuses that file's compiled JAX `predict_poses`.
`get_proportion_invalid_for_depth` is numpy in both packages: equal.
The demos run at height 32 with gen_dims 4 (their ResNet-101 or the
tiny ResNet) and must write every file they announce.
"""

import numpy as np
import pytest

from se3ds_torch.examples import mp3d_trajectory_demo
from se3ds_torch.examples import re10k_video_demo
from se3ds_torch.examples import vln_augmentation_demo
from se3ds_torch.inference import perturbation as perturbation_t
from se3ds_tpu.inference import perturbation as perturbation_j
from test_torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def test_proportion_invalid_for_depth_equals_jax():
  rs = np.random.RandomState(0)
  depth = rs.uniform(0.2, 0.6, (32, 64)).astype(np.float32)
  depth[10:20, 40:60] = 0.02  # an obstacle 0.4 m away
  offsets = rs.uniform([-1.5, -1.5, -0.1], [1.5, 1.5, 0.1], (64, 3))
  offsets[:4] = [[0, 0, 0], [0, 0, 0.1], [1.0, 0, 0], [0, -1.0, 0]]
  seen = set()
  for offset in offsets.astype(np.float32):
    for padding in (0.1, 0.5):
      want = perturbation_j.get_proportion_invalid_for_depth(offset, depth,
                                                             padding)
      got = perturbation_t.get_proportion_invalid_for_depth(offset, depth,
                                                            padding)
      assert got == want
      seen.add(want > 0)
  assert seen == {True, False}


@pytest.mark.parametrize('demo,args,files', [
    (mp3d_trajectory_demo, ['--resnet', 'tiny', '--frames', '2'],
     ['frame_0.png', 'frame_1.png', 'memory.ply']),
    (mp3d_trajectory_demo, ['--resnet', 'tiny', '--frames', '2', '--fused'],
     ['frame_0.png', 'frame_1.png', 'memory.ply']),
    (re10k_video_demo, ['--frames', '2'], ['persp_0.png', 'persp_1.png']),
    (vln_augmentation_demo, ['--num_samples', '2'],
     ['aug_0.png', 'aug_1.png']),
], ids=['mp3d', 'mp3d fused', 're10k', 'vln'])
def test_demo_writes_its_files(demo, args, files, tmp_path):
  from se3ds_torch.data import png
  demo.main(['--out', str(tmp_path), '--height', '32', '--gen_dims', '4',
             '--device', 'cpu', *args])
  assert sorted(p.name for p in tmp_path.iterdir()) == sorted(files)
  for name in files:
    data = (tmp_path / name).read_bytes()
    if name.endswith('.png'):
      image = png.decode_png(data)
      assert image.dtype == np.uint8 and image.shape[-1] == 3
      assert image.shape[0] == 32
    else:
      assert data.startswith(b'ply\n') and b'end_header\n' in data
