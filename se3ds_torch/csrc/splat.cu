// Packed z-buffer point splat ('fast' semantics) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_splat_kernel` (se3ds_tpu/ops/splat_pallas.py:87),
// which sorted the points by pixel and walked VMEM-resident rows. The
// function is order-free (a per-pixel minimum and a per-pixel maximum), so
// on this card it needs no sort. One thread per point runs the prelude of
// pixel.cuh inline (the main path reads world points and the camera
// offset, and computes the equirect view coordinates in registers, so no
// translated or view tensor is written) and folds the point into one word
// per pixel with unsigned atomicMin:
//   depth bits  min over valid points of the f32 depth. Valid depth is
//               > 0, so the unsigned order of the bits equals the float
//               order.
//   ~key        key = (255 - clip(depth / depth_scale * 255)) << 24 |
//               feature bytes; the minimum of ~key is the maximum of key.
// Both start at 0xFFFFFFFF, so one memset initialises the buffer: ~key =
// 0xFFFFFFFF is key 0, "no point", and depth bits 0xFFFFFFFF are a NaN
// that fminf(., depth_scale) reads as depth_scale. With the depth (the
// RGB cloud) the two words of a pixel are adjacent, so a point's two
// atomics land in one L2 sector; without it (the semantic cloud, whose
// depth nobody reads) only the key word exists. A resolve kernel, one
// thread per pixel, then writes what `splat.project_to_feat_fast` returns:
// the depth image clip(min(depth, depth_scale)) / depth_scale and the
// (B, H, W, C) f32 features, output_void_class where no point is. Min and
// max do not depend on the order of the atomics, so the result is bit for
// bit that of the plain version on the same view coordinates.
//
// What bounds it: each point reads 12 bytes of coordinates (x, y, z; the
// homogeneous row is not read) and 4*C bytes of features, coalesced along
// the point axis, and issues one or two atomics into 4 or 8 bytes per
// pixel, which at 1024x512 (2-4 MiB per batch element) stay in the 50 MB
// L2. The resolve reads the words and writes 4 + 4*C bytes per pixel.
// The byte bound per served frame is 0.0132 ms on an H100 SXM; PERF.md
// gives the measured times (chip_smoke.py phases 2 and 4).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel.cuh"

namespace {

__device__ __forceinline__ uint32_t feature_byte(float f) {
  // clip to [0, 255]; fmaxf maps NaN to 0.
  return (uint32_t)fminf(fmaxf(f, 0.0f), 255.0f);
}

template <bool kEquirect, bool kDepth>
__global__ void splat_fast_kernel(se3ds::Clouds clouds, float depth_scale,
                                  uint32_t* __restrict__ words) {
  const int64_t b = blockIdx.y;
  const se3ds::Cloud<kEquirect> cloud(clouds, b);
  const int channels = clouds.channels;
  uint32_t* w = words + b * (int64_t)clouds.height * clouds.width *
                            (kDepth ? 2 : 1);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < clouds.num_points; i += (int64_t)gridDim.x * blockDim.x) {
    int64_t flat;
    float z;
    if (!cloud.pixel(clouds, i, &flat, &z)) continue;
    uint32_t key = 0;
    bool non_void = true;
    for (int c = 0; c < channels; ++c) {
      const float f = cloud.feats[i * channels + c];
      non_void = non_void && (f != clouds.void_value);
      key |= feature_byte(f) << (8 * (channels - 1 - c));
    }
    if (!non_void) continue;
    const float q = fminf(
        fmaxf(__fmul_rn(__fdiv_rn(z, depth_scale), 255.0f), 0.0f), 255.0f);
    key |= (255u - (uint32_t)q) << 24;
    if (kDepth) {
      atomicMin(w + 2 * flat, __float_as_uint(z));
      if (key) atomicMin(w + 2 * flat + 1, ~key);
    } else if (key) {
      atomicMin(w + flat, ~key);
    }
  }
}

template <bool kDepth>
__global__ void resolve_fast_kernel(const uint32_t* __restrict__ words,
                                    int64_t num_pixels, int channels,
                                    float depth_scale, float out_void,
                                    float* __restrict__ depth,
                                    float* __restrict__ feat) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= num_pixels) return;
  uint32_t key;
  if (kDepth) {
    const uint2 word = reinterpret_cast<const uint2*>(words)[p];
    // fminf reads the empty word's NaN bits as depth_scale; valid depth is
    // > 0, so the clip at 0 of the plain version changes nothing.
    const float d = fminf(__uint_as_float(word.x), depth_scale);
    depth[p] = __fdiv_rn(d, depth_scale);
    key = ~word.y;
  } else {
    key = ~words[p];
  }
  for (int c = 0; c < channels; ++c) {
    feat[p * channels + c] =
        key ? (float)((key >> (8 * (channels - 1 - c))) & 0xFFu) : out_void;
  }
}

template <bool kEquirect, bool kDepth>
void launch_points(const se3ds::Clouds& clouds, int batch, float depth_scale,
                   uint32_t* words, cudaStream_t stream) {
  splat_fast_kernel<kEquirect, kDepth>
      <<<se3ds::point_grid(clouds.num_points, batch), 256, 0, stream>>>(
          clouds, depth_scale, words);
}

}  // namespace

// The point pass on `stream`: a memset of `words` to 0xFF, then one
// kernel launch. Returns cudaGetLastError() as an int.
// xyz: (B, 4, M) f32, unit stride along M, rows `row_stride` apart,
// batches `batch_stride` apart. offset: (B, 4) f32 camera positions (w
// ignored) for world points, or null for view coordinates. feats: (B, M, C)
// f32 with C <= 3, contiguous per batch, batch stride feats_bstride.
// words: (B, H*W, 2) u32 with need_depth, else (B, H*W).
extern "C" int se3ds_splat_fast(const float* xyz, int64_t row_stride,
                                int64_t batch_stride, const float* offset,
                                const float* feats, int64_t feats_bstride,
                                int batch, int64_t num_points, int channels,
                                int height, int width, float depth_scale,
                                float void_value, int need_depth,
                                uint32_t* words, cudaStream_t stream) {
  const size_t bytes = (size_t)batch * height * width * (need_depth ? 8 : 4);
  cudaError_t err = cudaMemsetAsync(words, 0xFF, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const se3ds::Clouds clouds{xyz,           row_stride, batch_stride,
                             offset,        feats,      feats_bstride,
                             num_points,    channels,   height,
                             width,         void_value};
  if (offset) {
    if (need_depth) {
      launch_points<true, true>(clouds, batch, depth_scale, words, stream);
    } else {
      launch_points<true, false>(clouds, batch, depth_scale, words, stream);
    }
  } else if (need_depth) {
    launch_points<false, true>(clouds, batch, depth_scale, words, stream);
  } else {
    launch_points<false, false>(clouds, batch, depth_scale, words, stream);
  }
  return (int)cudaGetLastError();
}

// The resolve on `stream`: one thread per pixel of the B*H*W in `words`.
// depth: (B*H*W) f32, written only with need_depth (else may be null).
// feat: (B*H*W, C) f32.
extern "C" int se3ds_splat_fast_resolve(const uint32_t* words,
                                        int64_t num_pixels, int channels,
                                        int need_depth, float depth_scale,
                                        float out_void, float* depth,
                                        float* feat, cudaStream_t stream) {
  if (num_pixels == 0) return 0;
  const unsigned blocks = se3ds::pixel_blocks(num_pixels);
  if (need_depth) {
    resolve_fast_kernel<true><<<blocks, 256, 0, stream>>>(
        words, num_pixels, channels, depth_scale, out_void, depth, feat);
  } else {
    resolve_fast_kernel<false><<<blocks, 256, 0, stream>>>(
        words, num_pixels, channels, depth_scale, out_void, depth, feat);
  }
  return (int)cudaGetLastError();
}
