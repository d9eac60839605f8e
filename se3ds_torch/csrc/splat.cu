// Packed z-buffer point splat ('fast' semantics) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_splat_kernel` (se3ds_tpu/ops/splat_pallas.py:87),
// which sorted the points by pixel and walked VMEM-resident rows. The
// function is order-free (a per-pixel minimum and a per-pixel maximum), so
// on this card it needs no sort: one thread per point computes the point's
// pixel and validity inline (`pixel_coords`, se3ds_torch/ops/splat.py) and
// folds itself into two per-pixel buffers with atomics:
//   zbuf[pixel] = min over valid points of the f32 depth (initialised to
//                 depth_scale). Valid depth is > 0, so the int order of the
//                 f32 bits equals the float order and atomicMin on int works.
//   pbuf[pixel] = max over valid points of the u32 key
//                 (255 - clip(depth / depth_scale * 255)) << 24 | feature bytes
//                 (initialised to 0, which decodes as "no point").
// Min and max do not depend on the order of the atomics, so the result is
// bit for bit that of the plain version (splat_cuda.splat_fast_plain).
//
// What bounds it: each point reads 12 bytes of coordinates (x, y, z; the
// homogeneous row is not read) and 4*C bytes of features, coalesced along
// the point axis, and issues two atomics into 8 bytes per pixel. At
// 1024x512 the two buffers hold 4 MiB per batch element and stay in the
// 50 MB L2, so the atomics resolve in L2; their throughput, not the
// 16-24 bytes per point read from device memory, is the expected limit.
//
// Rounding: the view divide, the pixel mapping (pixel.cuh) and the depth
// bucket are computed with IEEE division and without fused multiply-add
// (the build passes -fmad=false and no --use_fast_math), so every float
// rounds as the separate PyTorch operations of the plain version do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel.cuh"

namespace {

__device__ __forceinline__ uint32_t feature_byte(float f) {
  // clip to [0, 255]; fmaxf maps NaN to 0.
  return (uint32_t)fminf(fmaxf(f, 0.0f), 255.0f);
}

__global__ void splat_fast_kernel(const float* __restrict__ coords,
                                  const float* __restrict__ feats,
                                  int64_t num_points, int64_t coords_bstride,
                                  int64_t feats_bstride, int channels,
                                  int height, int width, float depth_scale,
                                  float void_value, float* __restrict__ zbuf,
                                  uint32_t* __restrict__ pbuf) {
  const int64_t b = blockIdx.y;
  const float* xs = coords + b * coords_bstride;
  const float* ys = xs + num_points;
  const float* zs = ys + num_points;
  const float* fb = feats + b * feats_bstride;
  const int64_t num_pixels = (int64_t)height * width;
  int* zb = reinterpret_cast<int*>(zbuf + b * num_pixels);
  uint32_t* pb = pbuf + b * num_pixels;

  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < num_points; i += (int64_t)gridDim.x * blockDim.x) {
    const float z = zs[i];
    int64_t flat;
    if (!se3ds::pixel_index(xs[i], ys[i], z, height, width, &flat)) continue;
    uint32_t key = 0;
    bool non_void = true;
    for (int c = 0; c < channels; ++c) {
      const float f = fb[i * channels + c];
      non_void = non_void && (f != void_value);
      key |= feature_byte(f) << (8 * (channels - 1 - c));
    }
    if (!non_void) continue;
    const float q = fminf(fmaxf(z / depth_scale * 255.0f, 0.0f), 255.0f);
    key |= (255u - (uint32_t)q) << 24;
    atomicMin(zb + flat, __float_as_int(z));
    atomicMax(pb + flat, key);
  }
}

}  // namespace

// Launches the splat on `stream`; returns cudaGetLastError() as an int.
// coords: (B, 4, M) f32 with rows contiguous, batch stride coords_bstride.
// feats: (B, M, C) f32 with C <= 3, contiguous per batch, batch stride
// feats_bstride. zbuf: (B, H*W) f32 filled with depth_scale; pbuf:
// (B, H*W) u32 filled with 0.
extern "C" int se3ds_splat_fast(const float* coords, const float* feats,
                                int batch, int64_t num_points,
                                int64_t coords_bstride, int64_t feats_bstride,
                                int channels, int height, int width,
                                float depth_scale, float void_value,
                                float* zbuf, uint32_t* pbuf,
                                cudaStream_t stream) {
  splat_fast_kernel<<<se3ds::point_grid(num_points, batch), 256, 0, stream>>>(
      coords, feats, num_points, coords_bstride, feats_bstride, channels,
      height, width, depth_scale, void_value, zbuf, pbuf);
  return (int)cudaGetLastError();
}
