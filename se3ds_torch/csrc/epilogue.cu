// The served generator's convolution epilogue in one pass (Hopper, sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fused these elementwise ops into
// the producers and consumers of each convolution. On this card PyTorch
// runs them one by one after cuDNN: a partial convolution's output is read
// and written again for `out - bias`, `* mask_ratio`, `+ bias`,
// `* update_mask`, the eval BatchNorm and the activation, a block's end
// once more for `+ residual`, and each op rounds to the compute dtype.
//
// What it computes, for each element of a (P, C) output in NHWC memory
// (P = N * H * W pixels), in float32 registers with one rounding to the
// output dtype at the end, in the order of `layers.epilogue_plain` (its
// plain version, whose ops round the same way: every float operation here
// is a round-to-nearest intrinsic, never fused):
//   operand a (a conv output), then optionally operand b (a second conv
//   output, or a plain residual tensor), each "settled":
//     partial conv (window sum ws of its mask, kernel area k):
//       update_mask = clamp(ws, 0, 1), ratio = (1 / (ws + 1e-6)) * k *
//       update_mask; with a bias ((x - bias) * ratio + bias) * update_mask,
//       without one x * ratio;
//     else with a bias: x + bias;
//     then with a BatchNorm (eval): (x - mean) * mul + shift, where
//       mul = (1 / sqrt(var + 1e-3)) * weight per channel (Flax's formula);
//   y = a (+ b before the activation), the activation (ReLU or LeakyReLU),
//   (+ b after it), then optionally the next layer's BatchNorm; and the
//   update mask of a partial operand a, one channel, as a second output.
//
// What bounds it: bytes. Each pass reads its conv output(s) and residual
// once, and writes its output (and the one-channel mask) once; the
// arithmetic is a few flops per byte.
//
// Design: vector loads and stores of V = 4 channels (16 bytes of float32,
// 8 of bf16; one value at a time where C is no multiple of 4). Thread t
// works on one fixed group of channels, t mod (C / V), at pixels
// t / (C / V) + k * rows, so its per-channel constants (bias, BatchNorm
// mean, mul and shift) are read and computed once and held in registers,
// and neighbouring threads touch neighbouring vectors. Registers set how
// many threads an SM holds, and so the bytes in flight: 4 channels a
// thread (not 8 bf16, a 16-byte vector) halve the constants' registers,
// and a second operand that is a plain residual keeps no constants (a
// template of its own). The grid is one wave of resident blocks (the
// occupancy of the variant), each thread striding over many pixels, four
// at a time (two with a second conv operand), all of whose loads are
// issued before any arithmetic. Launched on the caller's stream, it
// captures into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMaskEps = 1e-6f;  // PartialConv's eps
constexpr float kBnEps = 1e-3f;    // layers.BN_EPSILON

enum Activation { kNone = 0, kRelu = 1, kLeaky = 2 };

struct Operand {
  const void* x;           // (P, C), the pass's dtype; null: absent
  const void* window_sum;  // (P), same dtype; null: not a partial conv
  const float* bias;       // (C) or null
  const float* mean;       // (C) BatchNorm running mean, or null: no BN
  const float* var;        // (C) running variance
  const float* weight;     // (C) scale
  const float* shift;      // (C) bias
  float area;              // kernel area kh * kw of a partial conv
};

struct Params {
  Operand a, b;
  const float* post_mean;  // the next layer's BatchNorm, or null
  const float* post_var;
  const float* post_weight;
  const float* post_shift;
  void* out;               // (P, C)
  void* update_mask;       // (P) or null
  int64_t pixels;
  int channels;
  int act;
  float slope;
  int residual_after_act;
};

struct Consts {
  float bias, mean, mul, shift;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
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

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const void* base, int64_t off) {
  const T* ptr = static_cast<const T*>(base) + off;
  Pack<T, V> out;
  if constexpr (sizeof(Pack<T, V>) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(ptr));
    memcpy(&out, &raw, 16);
  } else if constexpr (sizeof(Pack<T, V>) == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(ptr));
    memcpy(&out, &raw, 8);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out.v[i] = ptr[i];
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void store(void* base, int64_t off,
                                      const Pack<T, V>& value) {
  T* ptr = static_cast<T*>(base) + off;
  if constexpr (sizeof(Pack<T, V>) == 16) {
    uint4 raw;
    memcpy(&raw, &value, 16);
    *reinterpret_cast<uint4*>(ptr) = raw;
  } else if constexpr (sizeof(Pack<T, V>) == 8) {
    uint2 raw;
    memcpy(&raw, &value, 8);
    *reinterpret_cast<uint2*>(ptr) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) ptr[i] = value.v[i];
  }
}

// BatchNorm's per-channel multiplier, (1 / sqrt(var + eps)) * weight.
__device__ __forceinline__ float norm_mul(float var, float weight) {
  return __fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(var, kBnEps))), weight);
}

__device__ __forceinline__ Consts channel_consts(const float* bias,
                                                 const float* mean,
                                                 const float* var,
                                                 const float* weight,
                                                 const float* shift, int c) {
  Consts k{0.0f, 0.0f, 0.0f, 0.0f};
  if (bias) k.bias = bias[c];
  if (mean) {
    k.mean = mean[c];
    k.mul = norm_mul(var[c], weight[c]);
    k.shift = shift[c];
  }
  return k;
}

__device__ __forceinline__ float normalise(float x, const Consts& k) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, k.mean), k.mul), k.shift);
}

// A partial conv's mask terms at one pixel: (ratio, update_mask).
__device__ __forceinline__ float2 mask_terms(float ws, float area) {
  const float update = fminf(fmaxf(ws, 0.0f), 1.0f);
  const float ratio = __fmul_rn(__frcp_rn(__fadd_rn(ws, kMaskEps)), area);
  return make_float2(__fmul_rn(ratio, update), update);
}

__device__ __forceinline__ float settle(float x, const Operand& o,
                                        const Consts& k, float2 mask) {
  if (o.window_sum) {
    if (o.bias) {
      x = __fmul_rn(
          __fadd_rn(__fmul_rn(__fsub_rn(x, k.bias), mask.x), k.bias), mask.y);
    } else {
      x = __fmul_rn(x, mask.x);
    }
  } else if (o.bias) {
    x = __fadd_rn(x, k.bias);
  }
  return o.mean ? normalise(x, k) : x;
}

__device__ __forceinline__ float activate(float x, int act, float slope) {
  if (act == kRelu) return x < 0.0f ? 0.0f : x;  // NaN stays NaN
  if (act == kLeaky) return x > 0.0f ? x : __fmul_rn(x, slope);
  return x;
}

// The second operand: none, a plain residual tensor, or a convolution
// output with its own renormalisation, bias or BatchNorm.
enum Second { kNoSecond = 0, kResidual = 1, kConvSecond = 2 };

template <typename T, int V, int kSecond, bool kPost>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const Params p) {
  const int groups = p.channels / V;
  const int64_t rows = (int64_t)gridDim.x * kThreads / groups;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * groups) return;
  const int g = (int)(t % groups);
  const int c0 = g * V;

  Consts ka[V], kb[V], kp[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ka[i] = channel_consts(p.a.bias, p.a.mean, p.a.var, p.a.weight,
                           p.a.shift, c0 + i);
    if (kSecond == kConvSecond) {
      kb[i] = channel_consts(p.b.bias, p.b.mean, p.b.var, p.b.weight,
                             p.b.shift, c0 + i);
    }
    if (kPost) {
      kp[i] = channel_consts(nullptr, p.post_mean, p.post_var, p.post_weight,
                             p.post_shift, c0 + i);
    }
  }

  // Pixels a thread has in flight: fewer where the second operand's
  // constants take registers.
  constexpr int kUnroll = kSecond == kConvSecond ? 2 : 4;
  for (int64_t first = t / groups; first < p.pixels;
       first += kUnroll * rows) {
    // Every load of the pixels first, then the arithmetic: a branch
    // between two loads (the reciprocal's slow path) would keep the
    // second from being issued before the first has returned.
    Pack<T, V> xa[kUnroll], xb[kUnroll];
    T wa[kUnroll], wb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t px = first + u * rows;
      if (px < p.pixels) {
        const int64_t off = px * p.channels + c0;
        xa[u] = load<T, V>(p.a.x, off);
        if (p.a.window_sum) {
          wa[u] = static_cast<const T*>(p.a.window_sum)[px];
        }
        if (kSecond != kNoSecond) xb[u] = load<T, V>(p.b.x, off);
        if (kSecond == kConvSecond && p.b.window_sum) {
          wb[u] = static_cast<const T*>(p.b.window_sum)[px];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t px = first + u * rows;
      if (px >= p.pixels) break;
      const float2 ma = p.a.window_sum ? mask_terms(to_float(wa[u]), p.a.area)
                                       : make_float2(1.0f, 1.0f);
      float2 mb = make_float2(1.0f, 1.0f);
      if (kSecond == kConvSecond && p.b.window_sum) {
        mb = mask_terms(to_float(wb[u]), p.b.area);
      }
      Pack<T, V> y;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float v = settle(to_float(xa[u].v[i]), p.a, ka[i], ma);
        float r = 0.0f;
        if (kSecond != kNoSecond) {
          r = to_float(xb[u].v[i]);
          if (kSecond == kConvSecond) r = settle(r, p.b, kb[i], mb);
          if (!p.residual_after_act) v = __fadd_rn(v, r);
        }
        v = activate(v, p.act, p.slope);
        if (kSecond != kNoSecond && p.residual_after_act) {
          v = __fadd_rn(v, r);
        }
        if (kPost) v = normalise(v, kp[i]);
        y.v[i] = from_float<T>(v);
      }
      store<T, V>(p.out, px * p.channels + c0, y);
      if (p.update_mask && g == 0) {
        static_cast<T*>(p.update_mask)[px] = from_float<T>(ma.y);
      }
    }
  }
}

// Blocks of `kernel` the card holds at once: its SMs times the blocks an
// SM fits by registers (asked once per variant and device).
template <typename Kernel>
int resident_blocks(Kernel kernel, int (&cache)[16]) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 16) {
    device = 0;
  }
  if (!cache[device]) {
    int sms = 132, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    cache[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[device];
}

template <typename T, int V, int kSecond, bool kPost>
void launch(const Params& p, cudaStream_t stream) {
  static int cache[16] = {0};
  const auto kernel = epilogue_kernel<T, V, kSecond, kPost>;
  const int64_t resident = resident_blocks(kernel, cache);
  const int64_t vectors = p.pixels * (p.channels / V);
  const int64_t wanted = (vectors + kThreads - 1) / kThreads;
  kernel<<<(int)(wanted < resident ? wanted : resident), kThreads, 0,
           stream>>>(p);
}

template <typename T, int V, int kSecond>
void dispatch_post(const Params& p, cudaStream_t stream) {
  if (p.post_mean) {
    launch<T, V, kSecond, true>(p, stream);
  } else {
    launch<T, V, kSecond, false>(p, stream);
  }
}

template <typename T, int V>
void dispatch(const Params& p, cudaStream_t stream) {
  if (!p.b.x) {
    dispatch_post<T, V, kNoSecond>(p, stream);
  } else if (p.b.window_sum || p.b.bias || p.b.mean) {
    dispatch_post<T, V, kConvSecond>(p, stream);
  } else {
    dispatch_post<T, V, kResidual>(p, stream);
  }
}

}  // namespace

// One epilogue pass on `stream`. Returns cudaGetLastError() as an int.
// dtype: 0 float32, 1 bfloat16. vector: 1, or 4, which C must be a
// multiple of, with every (P, C) tensor aligned to 4 values. pointers: 20
// device pointers, null where absent: operand a's x, window_sum, bias,
// mean, var, weight, shift; the same 7 of operand b; the next BatchNorm's
// mean, var, weight, shift; out; update_mask (written only where a has a
// window sum). Every (P, C) tensor is dense NHWC, every (P) tensor dense,
// every (C) vector float32.
extern "C" int se3ds_conv_epilogue(int dtype, int vector, int64_t pixels,
                                   int channels, const void* const* pointers,
                                   float area_a, float area_b, int act,
                                   float slope, int residual_after_act,
                                   cudaStream_t stream) {
  if (pixels == 0) return 0;
  const float* const* f = reinterpret_cast<const float* const*>(pointers);
  Params p;
  p.a = Operand{pointers[0], pointers[1], f[2], f[3], f[4], f[5], f[6],
                area_a};
  p.b = Operand{pointers[7], pointers[8], f[9], f[10], f[11], f[12], f[13],
                area_b};
  p.post_mean = f[14];
  p.post_var = f[15];
  p.post_weight = f[16];
  p.post_shift = f[17];
  p.out = const_cast<void*>(pointers[18]);
  p.update_mask = p.a.window_sum ? const_cast<void*>(pointers[19]) : nullptr;
  p.pixels = pixels;
  p.channels = channels;
  p.act = act;
  p.slope = slope;
  p.residual_after_act = residual_after_act;
  if (dtype == 0) {
    if (vector == 4) {
      dispatch<float, 4>(p, stream);
    } else {
      dispatch<float, 1>(p, stream);
    }
  } else {
    if (vector == 4) {
      dispatch<__nv_bfloat16, 4>(p, stream);
    } else {
      dispatch<__nv_bfloat16, 1>(p, stream);
    }
  }
  return (int)cudaGetLastError();
}
