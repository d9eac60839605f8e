"""VLN viewpoint-jitter augmentation demo (reference
notebooks/SE3DS_VLN_Augmentation_Colab.ipynb cell 13).

Samples collision-free position perturbations within 1.5 m of a source
viewpoint and synthesises views there for VLN agent data augmentation.

Usage:
  python -m se3ds_torch.examples.vln_augmentation_demo --out /tmp/vln \
      [--ckpt model_dir] [--height 256] [--num_samples 3] [--device cpu]
"""

import argparse
import os

import numpy as np


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--out', default='/tmp/se3ds_vln_demo')
  parser.add_argument('--ckpt', default=None,
                      help='A checkpoint the port wrote (SE3DSModel '
                      'ckpt_path); random weights without one.')
  parser.add_argument('--height', type=int, default=256)
  parser.add_argument('--gen_dims', type=int, default=128)
  parser.add_argument('--num_samples', type=int, default=3)
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'.")
  args = parser.parse_args(argv)

  from se3ds_torch.data import png as png_lib
  from se3ds_torch.inference import perturbation
  from se3ds_torch.models import inference, model_config

  os.makedirs(args.out, exist_ok=True)
  config = model_config.SE3DSConfig(
      ckpt_path=args.ckpt, image_height=args.height, gen_dims=args.gen_dims,
      resnet_version='101', memory_frames=2)
  model = inference.SE3DSModel(config, device=args.device)

  rng = np.random.RandomState(0)
  h, w = args.height, args.height * 2
  rgb = rng.randint(0, 256, (1, h, w, 3)).astype(np.int32)
  semantic = rng.randint(0, 42, (1, h, w, 1)).astype(np.int32)
  depth = rng.uniform(0.2, 0.9, (1, h, w)).astype(np.float32)
  start = np.zeros((1, 3), np.float32)
  model.add_to_memory(rgb, semantic, depth, start)

  results = perturbation.sample_perturbed_views(
      model, start, depth[0], args.num_samples, rng)
  for i, (position, outputs) in enumerate(results):
    frame = outputs.pred_rgb[0].cpu().numpy()
    with open(os.path.join(args.out, f'aug_{i}.png'), 'wb') as f:
      f.write(png_lib.encode_png(frame))
    print(f'aug {i}: position {position[0].tolist()} -> '
          f'{args.out}/aug_{i}.png')


if __name__ == '__main__':
  main()
