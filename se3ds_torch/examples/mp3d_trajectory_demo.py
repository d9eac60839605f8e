"""MP3D trajectory synthesis demo (reference MP3D trajectory notebook).

Loads (or randomly initialises) an SE3DS model, seeds the point-cloud
memory with a source RGB-D pano, then autoregressively synthesises a
trajectory of target views, writing PNG frames and a .ply point cloud.

Usage:
  python -m se3ds_torch.examples.mp3d_trajectory_demo --out /tmp/demo \
      [--ckpt model_dir] [--height 512] [--frames 4] [--device cpu]
"""

import argparse
import os

import numpy as np


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--out', default='/tmp/se3ds_demo')
  parser.add_argument('--ckpt', default=None,
                      help='A checkpoint the port wrote (SE3DSModel '
                      'ckpt_path); random weights without one.')
  parser.add_argument('--height', type=int, default=256)
  parser.add_argument('--gen_dims', type=int, default=128)
  parser.add_argument('--resnet', default='101')
  parser.add_argument('--frames', type=int, default=4)
  parser.add_argument('--rgb', default=None, help='Source pano PNG path.')
  parser.add_argument('--depth', default=None,
                      help='Source 16-bit depth PNG path.')
  parser.add_argument('--fused', action='store_true',
                      help='Synthesise the whole trajectory with one '
                      'predict_trajectory call instead of one call per '
                      'frame.')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'.")
  args = parser.parse_args(argv)

  from se3ds_torch.data import png as png_lib
  from se3ds_torch.models import inference, model_config

  os.makedirs(args.out, exist_ok=True)
  config = model_config.SE3DSConfig(
      ckpt_path=args.ckpt, image_height=args.height, gen_dims=args.gen_dims,
      resnet_version=args.resnet, memory_frames=args.frames + 1)
  model = inference.SE3DSModel(config, device=args.device)

  h, w = args.height, args.height * 2
  rng = np.random.RandomState(0)
  if args.rgb:
    with open(args.rgb, 'rb') as f:
      rgb = png_lib.decode_png(f.read()).astype(np.int32)[None]
  else:
    rgb = rng.randint(0, 256, (1, h, w, 3)).astype(np.int32)
  if args.depth:
    with open(args.depth, 'rb') as f:
      depth = png_lib.decode_png(f.read())
    depth = (depth.astype(np.float32) / 65535.0)[None]
  else:
    depth = rng.uniform(0.05, 0.6, (1, h, w)).astype(np.float32)
  semantic = np.zeros((1, h, w, 1), np.int32)

  model.add_to_memory(rgb, semantic, depth, np.zeros((1, 3), np.float32))
  step = np.array([[0.4, 0.0, 0.0]], np.float32)

  def write_frame(i, frame, coverage):
    with open(os.path.join(args.out, f'frame_{i}.png'), 'wb') as f:
      f.write(png_lib.encode_png(frame.cpu().numpy()))
    print(f'frame {i}: wrote {args.out}/frame_{i}.png '
          f'(guidance coverage {coverage:.3f})')

  if args.fused:
    positions = step[0] * np.arange(1, args.frames + 1)[:, None]
    traj = model.predict_trajectory(positions.astype(np.float32))
    for i in range(args.frames):
      write_frame(i, traj.pred_rgb[i, 0], float(traj.proj_mask[i].mean()))
  else:
    position = np.zeros((1, 3), np.float32)
    for i in range(args.frames):
      position = position + step
      out = model(position, add_preds_to_memory=True)
      write_frame(i, out.pred_rgb[0], float(out.proj_mask.mean()))
  model.write_memory_as_pointcloud(os.path.join(args.out, 'memory.ply'))
  print(f'wrote {args.out}/memory.ply')


if __name__ == '__main__':
  main()
