// Exact-window z-buffer point splat ('scatter' semantics) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_exact_splat_kernel`
// (se3ds_tpu/ops/splat_pallas.py:204), which sorted the points by (pixel,
// clipped depth) so that one streaming pass over VMEM-resident rows saw
// each pixel's final minimum before its window test. On this card the
// function is two order-free passes over the unsorted points, one thread
// per point, each running the prelude of pixel.cuh inline (world points
// minus the camera offset through the equirect view on the main path, so
// no translated or view tensor is written; a point's pixel is recomputed
// in pass 2, 12 bytes of rereading against 16 for writing and reading a
// cached index). Each pixel owns 1 + C adjacent u32 words, all set to
// 0xFFFFFFFF by one memset, and every fold is an unsigned atomicMin:
//   pass 1  word 0 = min over valid points of the raw f32 depth bits
//           (valid: in the image, in front of the camera, no channel equal
//           to the void value; depth > 0, so the unsigned order of the
//           bits equals the float order).
//   pass 2  a valid point whose RAW depth is < min(word 0, depth_scale) +
//           0.1f (DEPTH_COLLISION_TOLERANCE, an f32 sum, never fused)
//           folds ~order_key(feature) into word 1 + c for each channel c:
//           order_key maps f32 to u32 in float order, so the minimum of
//           its complement is the maximum feature. The plain version's
//           buffer starts at depth_scale and the memset does not, hence
//           the min with depth_scale (fminf also reads the empty word's
//           NaN bits as depth_scale).
// A resolve kernel, one thread per pixel, then writes what
// `splat.project_to_feat` returns: clip(min(depth, depth_scale)) /
// depth_scale and the (B, H, W, C) f32 features, each the max in key
// space of the window's features and output_void_class (the plain
// version's include_self=True keeps the void when every feature in the
// window is below it). Min and max do not depend on the order of the
// atomics, so the result is bit for bit that of the plain version.
//
// The second read. Both passes run in ONE persistent cooperative launch
// (cudaLaunchCooperativeKernel, a grid of as many blocks as fit on the
// card at once): pass 1 over every batch element, one grid-wide sync,
// then pass 2 in the reverse order of pass 1 (the last element first,
// its last point first), so that it meets first in the 50 MB L2 what
// pass 1 read last. Two alternatives measured slower on an H100 at batch
// 8, C=3 and 0.5M-2.1M points per element: walking the elements one at a
// time with a sync after each pass (so that pass 2 could find a whole
// element, 37.7 MB at the rollout's largest frame, in L2; the L2 did not
// hold the second read well enough to pay for 2*B grid syncs), and
// checking a pixel's word before each atomic. Caching each point's pixel
// in pass 1 instead of recomputing it gained nothing measurable.
//
// The split passes. A splat whose points are spread over several ranks
// (se3ds_torch/parallel/splat_shard.py) must test each point against the
// GLOBAL minimum, so the minima are combined between the passes: there,
// each pass is an ordinary launch of its own (`se3ds_splat_exact_pass`,
// the same kernel instantiated for one pass, with no grid sync), and the
// caller combines the words after each.
//
// What bounds it: the function reads 12 + 4*C bytes per point and writes
// 4 + 4*C per pixel; the atomics resolve in L2 (one per valid point, then
// C per point in the window).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel.cuh"

namespace cg = cooperative_groups;

namespace {

// Order-preserving map from f32 to u32: a < b as floats (with -0 < +0)
// exactly when order_key(a) < order_key(b) as unsigned integers.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

struct ExactArgs {
  se3ds::Clouds clouds;
  int batch;
  float depth_scale;
  float tolerance;
  uint32_t* words;  // (B, H*W, 1 + C)
};

// kPasses: 3 runs both passes with a grid sync between them (a
// cooperative launch only); 1 or 2 runs that pass alone.
template <bool kEquirect, int kPasses>
__global__ void __launch_bounds__(256)
    splat_exact_kernel(const ExactArgs args) {
  const se3ds::Clouds& clouds = args.clouds;
  const int channels = clouds.channels;
  const int64_t stride = 1 + channels;
  const int64_t num_points = clouds.num_points;
  const int64_t per_element = (int64_t)clouds.height * clouds.width * stride;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int b = 0; b < ((kPasses & 1) ? args.batch : 0); ++b) {
    const se3ds::Cloud<kEquirect> cloud(clouds, b);
    uint32_t* w = args.words + b * per_element;
    for (int64_t i = first; i < num_points; i += threads) {
      int64_t flat;
      float z;
      if (!cloud.pixel(clouds, i, &flat, &z) || !cloud.non_void(clouds, i)) {
        continue;
      }
      atomicMin(w + flat * stride, __float_as_uint(z));
    }
  }
  if constexpr (kPasses == 3) cg::this_grid().sync();
  // Reverse order: the last element first, point M-1-i for the i of
  // pass 1.
  for (int b = (kPasses & 2) ? args.batch - 1 : -1; b >= 0; --b) {
    const se3ds::Cloud<kEquirect> cloud(clouds, b);
    uint32_t* w = args.words + b * per_element;
    for (int64_t i = first; i < num_points; i += threads) {
      const int64_t j = num_points - 1 - i;
      int64_t flat;
      float z;
      if (!cloud.pixel(clouds, j, &flat, &z) || !cloud.non_void(clouds, j)) {
        continue;
      }
      // The window compares the RAW depth with the clipped minimum.
      const float zmin =
          fminf(__uint_as_float(__ldcg(w + flat * stride)), args.depth_scale);
      if (!(z < __fadd_rn(zmin, args.tolerance))) continue;
      for (int c = 0; c < channels; ++c) {
        atomicMin(w + flat * stride + 1 + c,
                  ~order_key(cloud.feats[j * channels + c]));
      }
    }
  }
}

__global__ void resolve_exact_kernel(const uint32_t* __restrict__ words,
                                     int64_t num_pixels, int channels,
                                     float depth_scale, uint32_t void_key,
                                     float* __restrict__ depth,
                                     float* __restrict__ feat) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= num_pixels) return;
  const uint32_t* w = words + p * (1 + channels);
  if (depth) {
    depth[p] = __fdiv_rn(fminf(__uint_as_float(w[0]), depth_scale),
                         depth_scale);
  }
  for (int c = 0; c < channels; ++c) {
    feat[p * channels + c] = from_order_key(max(~w[1 + c], void_key));
  }
}

template <bool kEquirect, int kPasses>
int launch_passes(const ExactArgs& args, cudaStream_t stream) {
  const void* kernel = (const void*)splat_exact_kernel<kEquirect, kPasses>;
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256,
                                                        0);
  }
  if (err != cudaSuccess) return (int)err;
  // As many blocks as run at once, fewer for a small cloud.
  int64_t blocks = (int64_t)sms * per_sm;
  const int64_t needed = (args.clouds.num_points + 255) / 256;
  if (needed < blocks) blocks = needed;
  if (blocks < 1) blocks = 1;
  if constexpr (kPasses != 3) {
    splat_exact_kernel<kEquirect, kPasses>
        <<<(unsigned)blocks, 256, 0, stream>>>(args);
    return (int)cudaGetLastError();
  }
  void* params[] = {const_cast<ExactArgs*>(&args)};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks),
                                          dim3(256), params, 0, stream);
}

ExactArgs exact_args(const float* xyz, int64_t row_stride,
                     int64_t batch_stride, const float* offset,
                     const float* feats, int64_t feats_bstride, int batch,
                     int64_t num_points, int channels, int height, int width,
                     float depth_scale, float void_value, float tolerance,
                     uint32_t* words) {
  return ExactArgs{
      se3ds::Clouds{xyz, row_stride, batch_stride, offset, feats,
                    feats_bstride, num_points, channels, height, width,
                    void_value},
      batch, depth_scale, tolerance, words};
}

int memset_words(uint32_t* words, int batch, int height, int width,
                 int channels, cudaStream_t stream) {
  const size_t bytes =
      (size_t)batch * height * width * (1 + channels) * sizeof(uint32_t);
  return (int)cudaMemsetAsync(words, 0xFF, bytes, stream);
}

}  // namespace

// Memset of `words` to 0xFF, then the one cooperative launch of both
// passes, on `stream`. Returns a CUDA error code as an int (0: launched).
// xyz: (B, 4, M) f32, unit stride along M, rows `row_stride` apart,
// batches `batch_stride` apart. offset: (B, 4) f32 camera positions (w
// ignored) for world points, or null for view coordinates. feats:
// (B, M, C) f32, contiguous per batch, batch stride feats_bstride.
// words: (B, H*W, 1 + C) u32.
extern "C" int se3ds_splat_exact(const float* xyz, int64_t row_stride,
                                 int64_t batch_stride, const float* offset,
                                 const float* feats, int64_t feats_bstride,
                                 int batch, int64_t num_points, int channels,
                                 int height, int width, float depth_scale,
                                 float void_value, float tolerance,
                                 uint32_t* words, cudaStream_t stream) {
  const int err = memset_words(words, batch, height, width, channels, stream);
  if (err != 0) return err;
  const ExactArgs args =
      exact_args(xyz, row_stride, batch_stride, offset, feats, feats_bstride,
                 batch, num_points, channels, height, width, depth_scale,
                 void_value, tolerance, words);
  return offset ? launch_passes<true, 3>(args, stream)
                : launch_passes<false, 3>(args, stream);
}

// One pass alone, an ordinary launch on `stream`: pass 1 (after the
// memset of `words` to 0xFF) folds the depths into word 0; pass 2 reads
// word 0 as the minimum (the caller may have combined it with other
// ranks' since pass 1) and folds the window's features into words 1..C.
// Arguments as se3ds_splat_exact's. Returns a CUDA error code as an int.
extern "C" int se3ds_splat_exact_pass(
    const float* xyz, int64_t row_stride, int64_t batch_stride,
    const float* offset, const float* feats, int64_t feats_bstride,
    int batch, int64_t num_points, int channels, int height, int width,
    float depth_scale, float void_value, float tolerance, int pass,
    uint32_t* words, cudaStream_t stream) {
  if (pass != 1 && pass != 2) return (int)cudaErrorInvalidValue;
  if (pass == 1) {
    const int err =
        memset_words(words, batch, height, width, channels, stream);
    if (err != 0) return err;
  }
  const ExactArgs args =
      exact_args(xyz, row_stride, batch_stride, offset, feats, feats_bstride,
                 batch, num_points, channels, height, width, depth_scale,
                 void_value, tolerance, words);
  if (pass == 1) {
    return offset ? launch_passes<true, 1>(args, stream)
                  : launch_passes<false, 1>(args, stream);
  }
  return offset ? launch_passes<true, 2>(args, stream)
                : launch_passes<false, 2>(args, stream);
}

// The resolve on `stream`: one thread per pixel of the B*H*W in `words`.
// depth: (B*H*W) f32, or null to skip it. feat: (B*H*W, C) f32. void_key:
// order_key(output_void_class).
extern "C" int se3ds_splat_exact_resolve(const uint32_t* words,
                                         int64_t num_pixels, int channels,
                                         float depth_scale, uint32_t void_key,
                                         float* depth, float* feat,
                                         cudaStream_t stream) {
  if (num_pixels == 0) return 0;
  resolve_exact_kernel<<<se3ds::pixel_blocks(num_pixels), 256, 0, stream>>>(
      words, num_pixels, channels, depth_scale, void_key, depth, feat);
  return (int)cudaGetLastError();
}
