// The per-point pixel rule shared by the splat kernels (the port's
// `splat.pixel_coords`, se3ds_torch/ops/splat.py).
//
// Rounding: the view divide and the pixel mapping use IEEE division and
// no fused multiply-add (the build passes -fmad=false and no
// --use_fast_math), so every float rounds as the separate PyTorch
// operations of the plain versions do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace se3ds {

// The flat pixel of a point at (x, y, z) if it lies in the image in front
// of the camera; false otherwise.
__device__ __forceinline__ bool pixel_index(float x, float y, float z,
                                            int height, int width,
                                            int64_t* flat) {
  // divide_no_nan: a point at depth 0 maps to view coordinate 0.
  const float vx = (z == 0.0f) ? 0.0f : x / z;
  const float vy = (z == 0.0f) ? 0.0f : y / z;
  const float fx = (vx + 1.0f) / 2.0f * (float)width;
  const float fy = (vy + 1.0f) / 2.0f * (float)height;
  // Truncation toward zero with NaN mapped to 0, bounds tested in float so
  // out-of-range values never reach an integer conversion.
  const float tx = isnan(fx) ? 0.0f : truncf(fx);
  const float ty = isnan(fy) ? 0.0f : truncf(fy);
  if (!(tx >= 0.0f && tx < (float)width && ty >= 0.0f &&
        ty < (float)height && z > 0.0f)) {
    return false;
  }
  *flat = (int64_t)ty * width + (int64_t)tx;
  return true;
}

// Grid for a grid-stride loop over `num_points` points of each of `batch`
// clouds: a few waves of 256-thread blocks cover any cloud size.
inline dim3 point_grid(int64_t num_points, int batch) {
  const int64_t max_blocks = 132 * 16;
  int64_t blocks = (num_points + 255) / 256;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  return dim3((unsigned)blocks, (unsigned)batch);
}

}  // namespace se3ds
