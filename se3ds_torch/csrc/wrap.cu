// A circularly padded convolution input in one pass (Hopper, sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fused the pad into the
// convolution's input. On this card PyTorch made each wrapped input three
// times: `F.pad` filled the whole height-padded tensor, copied the input
// into it, and `torch.cat` along the width copied that again, which in NHWC
// memory runs as strided copies (`layers._padded`, its plain version).
//
// What it writes, for an (N, H, W, C) input x in NHWC memory, pads `top`
// and `bottom` and a width margin m, and an optional (N, H, W) scale s:
// the (N, top + H + bottom, W + 2m, C) block whose rows top .. top + H - 1
// are x's rows extended circularly, column j = x[.., (j - m) mod W, ..]
// (times s at that pixel, in float32, rounded once to x's dtype, as
// PyTorch's own multiply rounds), and whose other rows are zero.
//
// What bounds it: bytes. Each input element is read once, each output
// element written once; a scale is one value a pixel. Nothing fills the
// block first.
//
// Design: one block row of the grid per output row (n, h); threads along
// the row. In NHWC memory an output row is the input row rotated by m * C
// elements and extended, so output element e of the row reads input
// element (e - m * C) mod (W * C) of its row: a row copy with a modular
// offset. Where C is a multiple of a 16-byte vector (8 bf16, 4 float32) and
// both tensors are 16-byte aligned, a thread moves whole vectors, which never
// cross a pixel or the row's wrap; else (the one-channel masks, the stem's
// 5-channel input) one value at a time. A thread starts all kUnroll loads of
// its vectors before any store, so that many loads are in flight (the
// epilogue kernel found that ordering worth 1.47 -> 2.01 TB/s). The margin
// may exceed W on tiny maps: the row offset is then taken modulo W * C in
// full. Launched on the caller's stream, it captures into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // vectors (or values) a thread has in flight
constexpr int kMaxRows = 65535;  // gridDim.y

struct Params {
  const void* x;      // (N, H, W, C)
  const void* scale;  // (N, H, W), x's dtype; null: none
  void* out;          // (N, top + H + bottom, W + 2 * margin, C)
  int64_t rows;       // N * (top + H + bottom)
  int h, w, c, top, padded_h, margin;
  bool wide;          // margin > W: reduce offsets modulo the row in full
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Element (unit) `t - shift` of a row of `length` units, taken circularly.
__device__ __forceinline__ int source(int j, int shift, int length,
                                      bool wide) {
  int t = j - shift;
  if (wide) {
    t %= length;
    return t < 0 ? t + length : t;
  }
  // margin <= W: j - shift lies in [-length, 2 * length).
  return t < 0 ? t + length : (t >= length ? t - length : t);
}

// units: 16-byte vectors (kVector) or single values of T.
template <typename T, bool kVector, bool kScale>
__global__ void __launch_bounds__(kThreads) wrap_kernel(const Params p) {
  using Unit = typename std::conditional<kVector, uint4, T>::type;
  constexpr int kPer = sizeof(Unit) / sizeof(T);  // values a unit
  const int in_units = p.w * p.c / kPer;
  const int shift = p.margin * p.c / kPer;
  const int out_units = in_units + 2 * shift;
  const int first = blockIdx.x * kThreads * kUnroll + threadIdx.x;
  for (int64_t row = blockIdx.y; row < p.rows; row += gridDim.y) {
    const int64_t n = row / p.padded_h;
    const int hs = (int)(row - n * p.padded_h) - p.top;
    Unit* out = static_cast<Unit*>(p.out) + row * out_units;
    if (hs < 0 || hs >= p.h) {  // a zero row of the height pad
      Unit zero;
      memset(&zero, 0, sizeof(Unit));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = first + u * kThreads;
        if (j < out_units) out[j] = zero;
      }
      continue;
    }
    const int64_t src_row = n * p.h + hs;
    const Unit* in = static_cast<const Unit*>(p.x) + src_row * in_units;
    // Every load of the thread's units first, then the stores.
    Unit v[kUnroll];
    T s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = first + u * kThreads;
      if (j < out_units) {
        const int t = source(j, shift, in_units, p.wide);
        v[u] = __ldg(in + t);
        if (kScale) {
          // A unit lies within one pixel: its first value's.
          s[u] = static_cast<const T*>(p.scale)[src_row * p.w +
                                                 t * kPer / p.c];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = first + u * kThreads;
      if (j >= out_units) break;
      if (kScale) {
        T vals[kPer];
        memcpy(vals, &v[u], sizeof(Unit));
        const float k = to_float(s[u]);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          vals[i] = from_float<T>(__fmul_rn(to_float(vals[i]), k));
        }
        memcpy(&v[u], vals, sizeof(Unit));
      }
      out[j] = v[u];
    }
  }
}

template <typename T, bool kVector, bool kScale>
void launch(const Params& p, cudaStream_t stream) {
  constexpr int kPer = kVector ? 16 / (int)sizeof(T) : 1;
  const int out_units = (p.w + 2 * p.margin) * p.c / kPer;
  const int per_block = kThreads * kUnroll;
  const dim3 grid((out_units + per_block - 1) / per_block,
                  (unsigned)(p.rows < kMaxRows ? p.rows : kMaxRows));
  wrap_kernel<T, kVector, kScale><<<grid, kThreads, 0, stream>>>(p);
}

template <typename T>
void dispatch(const Params& p, bool vector, cudaStream_t stream) {
  if (vector) {
    if (p.scale) {
      launch<T, true, true>(p, stream);
    } else {
      launch<T, true, false>(p, stream);
    }
  } else if (p.scale) {
    launch<T, false, true>(p, stream);
  } else {
    launch<T, false, false>(p, stream);
  }
}

}  // namespace

// One wrap pass on `stream`. Returns cudaGetLastError() as an int.
// dtype: 0 float32, 1 bfloat16. vector: 1 where C is a multiple of 16 bytes'
// values and x and out are 16-byte aligned, else 0. x: dense (N, H, W, C);
// scale: dense (N, H, W) of x's dtype, or null; out: dense (N, top + H +
// bottom, W + 2 * margin, C). W > 0 where margin > 0.
extern "C" int se3ds_wrap_pad(int dtype, int vector, int n, int c, int h,
                              int w, int top, int bottom, int margin,
                              const void* x, const void* scale, void* out,
                              cudaStream_t stream) {
  Params p;
  p.x = x;
  p.scale = scale;
  p.out = out;
  p.padded_h = top + h + bottom;
  p.rows = (int64_t)n * p.padded_h;
  p.h = h;
  p.w = w;
  p.c = c;
  p.top = top;
  p.margin = margin;
  p.wide = margin > w;
  if (p.rows == 0 || c == 0 || w + 2 * margin == 0) return 0;
  if (w == 0) return (int)cudaErrorInvalidValue;  // nothing to wrap
  if (dtype == 0) {
    dispatch<float>(p, vector != 0, stream);
  } else {
    dispatch<__nv_bfloat16>(p, vector != 0, stream);
  }
  return (int)cudaGetLastError();
}
