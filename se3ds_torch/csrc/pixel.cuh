// The per-point prelude shared by the splat kernels: where a point lands
// and whether it is valid (the port's `splat.pixel_coords` and
// `geometry.equirect_view_coords`, se3ds_torch/ops/).
//
// Rounding: every float operation outside the math library is written
// with a round-to-nearest intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn), which nvcc never contracts into a fused multiply-add, so
// each rounds as the separate PyTorch operation of the plain version
// does. atan2f and acosf come from the CUDA math library, as PyTorch's
// own CUDA kernels take them; the sources build with nvcc's default
// -fmad=true, as PyTorch's kernels are built, so the library's bits are
// the plain version's on the card.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace se3ds {

// f32(pi), f32(2 pi) and f32(1.5 pi): the Python constants as PyTorch
// rounds them against a float32 tensor.
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kTwoPi = 0x1.921fb6p+2f;
constexpr float kThreeHalvesPi = 0x1.2d97c8p+2f;

// `geometry.equirect_view_coords` of one point: (x, y, z) relative to the
// camera -> (proj_x, proj_y, rad), whose perspective divide lands on the
// pano pixel.
__device__ __forceinline__ void equirect_view(float x, float y, float z,
                                              float* vx, float* vy,
                                              float* vz) {
  const float rad = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
  float heading = __fsub_rn(kThreeHalvesPi, atan2f(y, x));
  if (heading <= 0.0f) heading = __fadd_rn(heading, kTwoPi);
  if (heading > kTwoPi) heading = __fsub_rn(heading, kTwoPi);
  // divide_no_nan, then torch.clamp, which keeps NaN (fminf would not).
  float cos_elev = (rad == 0.0f) ? 0.0f : __fdiv_rn(z, rad);
  if (!isnan(cos_elev)) cos_elev = fminf(fmaxf(cos_elev, -1.0f), 1.0f);
  const float elevation = acosf(cos_elev);
  *vx = __fmul_rn(rad, __fsub_rn(__fmul_rn(__fdiv_rn(heading, kTwoPi), 2.0f),
                                 1.0f));
  *vy = __fmul_rn(rad, __fsub_rn(__fmul_rn(__fdiv_rn(elevation, kPi), 2.0f),
                                 1.0f));
  *vz = rad;
}

// The flat pixel of a point at view coordinates (x, y, z) if it lies in
// the image in front of the camera; false otherwise. The divide x / z is
// kept even after equirect_view's rad * (...): dropping the round trip
// would change bits.
__device__ __forceinline__ bool pixel_index(float x, float y, float z,
                                            int height, int width,
                                            int64_t* flat) {
  // divide_no_nan: a point at depth 0 maps to view coordinate 0.
  const float vx = (z == 0.0f) ? 0.0f : __fdiv_rn(x, z);
  const float vy = (z == 0.0f) ? 0.0f : __fdiv_rn(y, z);
  const float fx = __fmul_rn(__fmul_rn(__fadd_rn(vx, 1.0f), 0.5f),
                             (float)width);
  const float fy = __fmul_rn(__fmul_rn(__fadd_rn(vy, 1.0f), 0.5f),
                             (float)height);
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

// A batch of point clouds as the kernels read them: rows x, y, z of a
// (B, 4, M) f32 tensor (unit stride along the points, any row and batch
// stride, so a slice of the memory needs no copy), (B, M, C) f32
// features, and for world points a (B, 4) f32 camera offset.
struct Clouds {
  const float* xyz;
  int64_t row_stride;
  int64_t batch_stride;
  const float* offset;  // (B, 4), read by the Equirect prelude only
  const float* feats;
  int64_t feats_bstride;
  int64_t num_points;
  int channels;
  int height;
  int width;
  float void_value;
};

// Point i of one batch element: its pixel and depth (the z of its view
// coordinates) if it is valid. `kEquirect` selects the prelude: world
// points minus the camera offset through equirect_view (the main path),
// or view coordinates as given.
template <bool kEquirect>
struct Cloud {
  const float* xs;
  const float* ys;
  const float* zs;
  const float* feats;
  float ox, oy, oz;

  __device__ __forceinline__ Cloud(const Clouds& c, int64_t b) {
    xs = c.xyz + b * c.batch_stride;
    ys = xs + c.row_stride;
    zs = ys + c.row_stride;
    feats = c.feats + b * c.feats_bstride;
    ox = oy = oz = 0.0f;
    if (kEquirect) {
      ox = c.offset[4 * b];
      oy = c.offset[4 * b + 1];
      oz = c.offset[4 * b + 2];
    }
  }

  __device__ __forceinline__ bool pixel(const Clouds& c, int64_t i,
                                        int64_t* flat, float* depth) const {
    float x = xs[i], y = ys[i], z = zs[i];
    if (kEquirect) {
      equirect_view(__fsub_rn(x, ox), __fsub_rn(y, oy), __fsub_rn(z, oz), &x,
                    &y, &z);
    }
    *depth = z;
    return pixel_index(x, y, z, c.height, c.width, flat);
  }

  // False if any channel of point i is the void value.
  __device__ __forceinline__ bool non_void(const Clouds& c, int64_t i) const {
    for (int k = 0; k < c.channels; ++k) {
      if (feats[i * c.channels + k] == c.void_value) return false;
    }
    return true;
  }
};

// Grid for a grid-stride loop over `num_points` points of each of `batch`
// clouds: a few waves of 256-thread blocks cover any cloud size.
inline dim3 point_grid(int64_t num_points, int batch) {
  const int64_t max_blocks = 132 * 16;
  int64_t blocks = (num_points + 255) / 256;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  return dim3((unsigned)blocks, (unsigned)batch);
}

// One thread per element of a per-pixel resolve.
inline unsigned pixel_blocks(int64_t count) {
  return (unsigned)((count + 255) / 256);
}

}  // namespace se3ds
