"""RE10K perspective video synthesis demo (reference
notebooks/SE3DS_RE10K_Colab.ipynb cells 10/15/17).

Pipeline: perspective RGB + (inverse) depth -> project to equirectangular
-> unproject to point cloud -> splat at a new camera pose -> generator
inpaints -> extract perspective view.

Usage:
  python -m se3ds_torch.examples.re10k_video_demo --out /tmp/re10k \
      [--ckpt model_dir] [--height 256] [--frames 3] [--device cpu]
"""

import argparse
import dataclasses
import os

import numpy as np


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--out', default='/tmp/se3ds_re10k_demo')
  parser.add_argument('--ckpt', default=None,
                      help='A checkpoint the port wrote (SE3DSModel '
                      'ckpt_path); random weights without one.')
  parser.add_argument('--height', type=int, default=256)
  parser.add_argument('--gen_dims', type=int, default=128)
  parser.add_argument('--frames', type=int, default=3)
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'.")
  args = parser.parse_args(argv)

  import torch
  from se3ds_torch.data import png as png_lib
  from se3ds_torch.models import inference, model_config
  from se3ds_torch.ops import geometry

  os.makedirs(args.out, exist_ok=True)
  # RE10K panos are written unmasked (mask_blurred=False below), which the
  # RE10K config's uncompacted RGB layout allows.
  config = dataclasses.replace(
      model_config.get_re10k_config(), ckpt_path=args.ckpt,
      image_height=args.height, gen_dims=args.gen_dims,
      memory_frames=args.frames + 1)
  model = inference.SE3DSModel(config, device=args.device)
  device = model.device

  # Synthetic perspective source (stand-in for an RE10K frame + MiDaS
  # depth; swap in real data via PNG paths as needed).
  rng = np.random.RandomState(0)
  ph, pw = args.height, args.height
  persp_rgb = rng.randint(0, 256, (ph, pw, 3)).astype(np.float32)
  persp_depth = rng.uniform(0.1, 0.5, (ph, pw, 1)).astype(np.float32)

  fov = torch.tensor([0.8, 0.8], device=device)
  pano_rgb = geometry.project_perspective_image(
      torch.from_numpy(persp_rgb).to(device), fov, output_height=args.height,
      pad_value=-1.0)
  pano_depth = geometry.project_perspective_image(
      torch.from_numpy(persp_depth).to(device), fov,
      output_height=args.height, pad_value=0.0)[..., 0]

  rgb = torch.clamp(pano_rgb, 0, 255).to(torch.int32)[None]
  depth = torch.clamp(pano_depth, 0, 1)[None]
  semantic = torch.zeros((1, args.height, args.height * 2, 1),
                         dtype=torch.int32, device=device)
  model.add_to_memory(rgb, semantic, depth,
                      np.zeros((1, 3), np.float32), mask_blurred=False)

  intrinsics = torch.diag(torch.tensor([pw, ph, 1.0], device=device))
  position = np.zeros((1, 3), np.float32)
  for i in range(args.frames):
    position = position + np.array([[0.1, 0.05, 0.0]], np.float32)
    out = model(position, add_preds_to_memory=True)
    persp = geometry.get_perspective_from_equirectangular_image(
        out.pred_rgb[0].to(torch.float32), intrinsics,
        torch.eye(3, device=device), height=ph, width=pw)
    frame = torch.clamp(persp, 0, 255).to(torch.uint8).cpu().numpy()
    with open(os.path.join(args.out, f'persp_{i}.png'), 'wb') as f:
      f.write(png_lib.encode_png(frame))
    print(f'frame {i}: wrote {args.out}/persp_{i}.png')


if __name__ == '__main__':
  main()
