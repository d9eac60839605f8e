// Exact-window z-buffer point splat ('scatter' semantics) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_exact_splat_kernel`
// (se3ds_tpu/ops/splat_pallas.py:204), which sorted the points by (pixel,
// clipped depth) so that one streaming pass over VMEM-resident rows saw
// each pixel's final minimum before its window test. On this card the
// function is two order-free passes over the unsorted points, one thread
// per point, each computing the point's pixel and validity inline
// (pixel.cuh, and no channel equal to the void value):
//   pass 1  zbuf[pixel] = min over valid points of the raw f32 depth
//           (initialised to depth_scale, so it is the min of the clipped
//           depth). Valid depth is > 0, so the int order of the f32 bits
//           equals the float order and atomicMin on int works.
//   pass 2  runs after pass 1 has finished (the next launch on the same
//           stream). A valid point whose RAW depth is < zbuf[pixel] + 0.1f
//           (DEPTH_COLLISION_TOLERANCE, added in f32 and never fused) folds
//           each channel into fbuf[pixel][c] with atomicMax. Features are
//           any float (the void value is -1), so the max runs on an
//           order-preserving u32 encoding of the f32 bits; fbuf is
//           initialised to the encoding of output_void_class and decoded
//           by the caller.
// Min and max do not depend on the order of the atomics, so the result is
// bit for bit that of the plain version (splat_cuda.splat_exact_plain).
//
// What bounds it: pass 1 reads 12 bytes of coordinates and 4*C of features
// per point, pass 2 the same plus the 4-byte z-buffer entry, coalesced
// along the point axis; the buffers take 4 + 4*C bytes per pixel. At
// 1024x512 they hold 8 MiB (C=3) per batch element, inside the 50 MB L2
// at batch 1 to 4, so the atomics resolve in L2: one atomicMin plus C
// atomicMax per point in the window. Measured on an H100 SXM (700 W) at
// batch 8, C=3 and 2.1M points per element, the kernel moves its own
// two-pass traffic (52 bytes per point, 16 per pixel) at ~2.3 TB/s, ~70%
// of the memory rate: the second read of every point, not the atomics,
// is what keeps it ~3x above the function's byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel.cuh"

namespace {

// Order-preserving map from f32 to u32: a < b as floats (with -0 < +0)
// exactly when order_key(a) < order_key(b) as unsigned integers.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Cloud {
  const float* xs;
  const float* ys;
  const float* zs;
  const float* feats;  // (M, C) of this batch element
};

__device__ __forceinline__ Cloud cloud_of(const float* coords,
                                          const float* feats,
                                          int64_t num_points,
                                          int64_t coords_bstride,
                                          int64_t feats_bstride) {
  const int64_t b = blockIdx.y;
  const float* xs = coords + b * coords_bstride;
  return Cloud{xs, xs + num_points, xs + 2 * num_points,
               feats + b * feats_bstride};
}

// The pixel of point i if it is valid: in the image, in front of the
// camera, and no feature channel equal to the void value.
__device__ __forceinline__ bool valid_pixel(const Cloud& cloud, int64_t i,
                                            int channels, int height,
                                            int width, float void_value,
                                            int64_t* flat) {
  if (!se3ds::pixel_index(cloud.xs[i], cloud.ys[i], cloud.zs[i], height,
                          width, flat)) {
    return false;
  }
  for (int c = 0; c < channels; ++c) {
    if (cloud.feats[i * channels + c] == void_value) return false;
  }
  return true;
}

__global__ void exact_depth_kernel(const float* __restrict__ coords,
                                   const float* __restrict__ feats,
                                   int64_t num_points, int64_t coords_bstride,
                                   int64_t feats_bstride, int channels,
                                   int height, int width, float void_value,
                                   float* __restrict__ zbuf) {
  const Cloud cloud = cloud_of(coords, feats, num_points, coords_bstride,
                               feats_bstride);
  int* zb = reinterpret_cast<int*>(zbuf + blockIdx.y * (int64_t)height *
                                              width);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < num_points; i += (int64_t)gridDim.x * blockDim.x) {
    int64_t flat;
    if (!valid_pixel(cloud, i, channels, height, width, void_value, &flat)) {
      continue;
    }
    atomicMin(zb + flat, __float_as_int(cloud.zs[i]));
  }
}

__global__ void exact_feats_kernel(const float* __restrict__ coords,
                                   const float* __restrict__ feats,
                                   int64_t num_points, int64_t coords_bstride,
                                   int64_t feats_bstride, int channels,
                                   int height, int width, float void_value,
                                   float tolerance,
                                   const float* __restrict__ zbuf,
                                   uint32_t* __restrict__ fbuf) {
  const Cloud cloud = cloud_of(coords, feats, num_points, coords_bstride,
                               feats_bstride);
  const int64_t num_pixels = (int64_t)height * width;
  const float* zb = zbuf + blockIdx.y * num_pixels;
  uint32_t* fb = fbuf + blockIdx.y * num_pixels * channels;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < num_points; i += (int64_t)gridDim.x * blockDim.x) {
    int64_t flat;
    if (!valid_pixel(cloud, i, channels, height, width, void_value, &flat)) {
      continue;
    }
    // The window compares the RAW depth with the clipped minimum.
    if (!(cloud.zs[i] < zb[flat] + tolerance)) continue;
    for (int c = 0; c < channels; ++c) {
      atomicMax(fb + flat * channels + c,
                order_key(cloud.feats[i * channels + c]));
    }
  }
}

}  // namespace

// The two passes, each launched on `stream`; each returns
// cudaGetLastError() as an int. Run se3ds_splat_exact_depth to its end
// (the same stream orders it) before se3ds_splat_exact_feats.
// coords: (B, 4, M) f32 with rows contiguous, batch stride coords_bstride.
// feats: (B, M, C) f32, contiguous per batch, batch stride feats_bstride.
// zbuf: (B, H*W) f32 filled with depth_scale. fbuf: (B, H*W, C) u32 filled
// with the order key of output_void_class.
extern "C" int se3ds_splat_exact_depth(const float* coords, const float* feats,
                                       int batch, int64_t num_points,
                                       int64_t coords_bstride,
                                       int64_t feats_bstride, int channels,
                                       int height, int width, float void_value,
                                       float* zbuf, cudaStream_t stream) {
  exact_depth_kernel<<<se3ds::point_grid(num_points, batch), 256, 0,
                       stream>>>(coords, feats, num_points, coords_bstride,
                                 feats_bstride, channels, height, width,
                                 void_value, zbuf);
  return (int)cudaGetLastError();
}

extern "C" int se3ds_splat_exact_feats(const float* coords, const float* feats,
                                       int batch, int64_t num_points,
                                       int64_t coords_bstride,
                                       int64_t feats_bstride, int channels,
                                       int height, int width, float void_value,
                                       float tolerance, const float* zbuf,
                                       uint32_t* fbuf, cudaStream_t stream) {
  exact_feats_kernel<<<se3ds::point_grid(num_points, batch), 256, 0,
                       stream>>>(coords, feats, num_points, coords_bstride,
                                 feats_bstride, channels, height, width,
                                 void_value, tolerance, zbuf, fbuf);
  return (int)cudaGetLastError();
}
