// conv1d: causal depthwise convolution of width W followed by silu, over
// (B, S, C) channels-last activations (the Mamba2 block's conv).
//
// Replaces: src/repro/kernels/conv1d.py::_conv_call (line 44), its inner
//   `body` (line 54): out[b, s, c] = silu(acc), with acc built in f32 as
//   0 + x[s-W+1]*w[0] + ... + x[s]*w[W-1], then + bias, and stored in x's
//   dtype (f32 or bf16).  Rows before s = 0 come from `state` (B, W-1, C),
//   the previous sequence's tail, or are zero (_prepend_halo, line 124).
//
// What bounds it on an H100: bytes, with the silu's instructions close
// behind.  Per output element it reads one input and writes one output
// (2 + 2 bytes in bf16) and does 2W + 1 flops plus one exp and one IEEE
// reciprocal.  The least time is x read once plus out written once at
// 3.35 TB/s: 0.0526 ms for Mamba2-2.7B's prefill conv (4 x 2048 x 5376
// bf16).  The exact expf and reciprocal that bit-equality needs cost
// about 30 instructions an element, ~0.04 ms of issue for those 44 M
// elements, so the loads must stay in flight while they issue.
//
// What the design does about it:
// * One warp owns one run of at most kRun = 32 rows of one token tile,
//   across 32 * V channels (a slab): each lane moves V = 4 neighbouring
//   channels (8 bytes of bf16, 16 of f32) where C and the buffers'
//   alignment allow, else 2 or 1 (the wrapper picks V).  A warp's row is
//   one contiguous 256-byte (bf16) access.  Eight bf16 channels a lane
//   took 128 registers and left 16 warps an SM; four take 74 and leave
//   24, and ran faster on the card.
// * Each lane issues the loads of its next kUnroll = 4 rows before it
//   computes the 4 it holds, so a warp keeps 1 KB (bf16) in flight while
//   it computes.
// * Each run re-reads its own W-1 halo rows (from x before the run, from
//   `state` before s = 0, else zeros): under 10% more reads at 32 rows,
//   most of them from L2.  Warps are a flat list of (batch row, tile,
//   run, slab) items, slab fastest, so the grid has no 65,535 limit and
//   holds ~10,750 warps for the prefill conv.  The tile is the caller's
//   (`tile_s`, the reference's meaning): runs never cross a tile's end,
//   and the result does not depend on it.
// * Index arithmetic is 32-bit inside a run; only the run's base pointer
//   is computed in 64 bits.  The weights and bias are read in their own
//   dtype (f32 or bf16, a run-time code) and widened to f32 in registers.
//
// Bit-exactness: the multiply-adds are separate __fmul_rn / __fadd_rn in
// the reference's order (built with --fmad=false), and silu is
// acc * (1 / (1 + expf(-acc))), the form ATen's f32 sigmoid takes on the
// card; the reciprocal is __frcp_rn, the correctly rounded 1 / y that the
// IEEE divide 1.0f / y also gives.  So the kernel equals the plain
// PyTorch version in kernels/conv1d.py bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 32;     // rows of one warp's run (= _RUN in conv1d.py)
constexpr int kUnroll = 4;   // rows a lane holds; as many more in flight
constexpr int kMaxWidth = 4;

struct ConvParams {
  const void* x;      // (B, S, C), f32 or bf16
  const void* state;  // (B, W-1, C) in x's dtype, or null for zeros
  const void* w;      // (W, C), f32 or bf16 (w_dtype)
  const void* bias;   // (C,), f32 or bf16 (b_dtype)
  void* out;          // (B, S, C) in x's dtype
  unsigned items;     // warps' work items: B * ntiles * runs * nslabs
  unsigned nslabs, runs, ntiles;
  int S, C, tile_s;
  int w_dtype, b_dtype;  // 0 float32, 1 bfloat16
};

// V elements of T as one load: 2, 4, 8 or 16 bytes.
template <int B>
struct Raw;
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
using RawOf = typename Raw<V * static_cast<int>(sizeof(T))>::type;

template <typename T, int V>
__device__ __forceinline__ RawOf<T, V> load_raw(const T* p) {
  return __ldg(reinterpret_cast<const RawOf<T, V>*>(p));
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const RawOf<T, V>& r,
                                       float (&v)[V]) {
  T e[V];
  memcpy(e, &r, sizeof(r));
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  T e[V];
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
  RawOf<T, V> r;
  memcpy(&r, e, sizeof(r));
  *reinterpret_cast<RawOf<T, V>*>(p) = r;
}

// A weight or bias element in its own dtype, widened exactly to f32.
__device__ __forceinline__ float param(const void* p, int dtype, int i) {
  return dtype == 1
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// silu(a) = a * sigmoid(a), sigmoid written as ATen writes it for f32.
__device__ __forceinline__ float silu(float a) {
  const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-a)));
  return __fmul_rn(a, sig);
}

// Output row from the window win[0..W-1] (input rows s-W+1 .. s).
template <int W, int V>
__device__ __forceinline__ void conv_row(const float (&win)[W][V],
                                         const float (&w)[W][V],
                                         const float (&bias)[V],
                                         float (&o)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < W; ++t)
      acc = __fadd_rn(acc, __fmul_rn(win[t][v], w[t][v]));
    o[v] = silu(__fadd_rn(acc, bias[v]));
  }
}

template <int W, int V>
__device__ __forceinline__ void shift(float (&win)[W][V]) {
#pragma unroll
  for (int t = 0; t < W - 1; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) win[t][v] = win[t + 1][v];
}

template <typename T, int W, int V>
__global__ void __launch_bounds__(kThreads, 2)
    conv1d_silu_kernel(const __grid_constant__ ConvParams P) {
  const unsigned item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= P.items) return;
  const int slab = static_cast<int>(item % P.nslabs);
  unsigned rest = item / P.nslabs;
  const int run = static_cast<int>(rest % P.runs);
  rest /= P.runs;
  const int tile = static_cast<int>(rest % P.ntiles);
  const int b = static_cast<int>(rest / P.ntiles);
  const int c0 = (slab * 32 + (threadIdx.x & 31)) * V;
  const int t0 = tile * P.tile_s;
  const int s0 = t0 + run * kRun;
  const int n = min(min(kRun, t0 + P.tile_s - s0), P.S - s0);
  if (c0 >= P.C || n <= 0) return;
  const int C = P.C;
  const long long base = (static_cast<long long>(b) * P.S + s0) * C + c0;
  const T* x = static_cast<const T*>(P.x) + base;
  T* out = static_cast<T*>(P.out) + base;

  float w[W][V];
  float bias[V];
#pragma unroll
  for (int t = 0; t < W; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) w[t][v] = param(P.w, P.w_dtype, t * C + c0 + v);
#pragma unroll
  for (int v = 0; v < V; ++v) bias[v] = param(P.bias, P.b_dtype, c0 + v);

  // win[t] holds input row s - (W-1) + t of the current output row s;
  // first the run's W-1 halo rows.
  float win[W][V];
#pragma unroll
  for (int t = 0; t < W - 1; ++t) {
    const int r = s0 - (W - 1) + t;
    if (r >= 0) {
      unpack<T, V>(load_raw<T, V>(x + (t - (W - 1)) * C), win[t]);
    } else if (P.state != nullptr) {
      const T* st = static_cast<const T*>(P.state) +
                    (static_cast<long long>(b) * (W - 1) + (W - 1) + r) * C +
                    c0;
      unpack<T, V>(load_raw<T, V>(st), win[t]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) win[t][v] = 0.0f;
    }
  }

  // Rows in chunks of kUnroll: the next chunk's loads are issued before
  // the current chunk is computed, so a lane always has a chunk of loads
  // in flight.
  RawOf<T, V> raw[kUnroll];
  const int full = n / kUnroll * kUnroll;
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = load_raw<T, V>(x + u * C);
  }
  for (int i = 0; i < full; i += kUnroll) {
    const bool more = i + kUnroll < full;
    RawOf<T, V> next[kUnroll];
    if (more) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        next[u] = load_raw<T, V>(x + (i + kUnroll + u) * C);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unpack<T, V>(raw[u], win[W - 1]);
      float o[V];
      conv_row<W, V>(win, w, bias, o);
      store<T, V>(out + (i + u) * C, o);
      shift<W, V>(win);
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = next[u];
    }
  }
#pragma unroll 1
  for (int i = full; i < n; ++i) {
    unpack<T, V>(load_raw<T, V>(x + i * C), win[W - 1]);
    float o[V];
    conv_row<W, V>(win, w, bias, o);
    store<T, V>(out + i * C, o);
    shift<W, V>(win);
  }
}

using KernelFn = void (*)(ConvParams);

template <typename T, int V>
KernelFn pick_width(int width) {
  switch (width) {
    case 1: return conv1d_silu_kernel<T, 1, V>;
    case 2: return conv1d_silu_kernel<T, 2, V>;
    case 3: return conv1d_silu_kernel<T, 3, V>;
    case 4: return conv1d_silu_kernel<T, 4, V>;
    default: return nullptr;
  }
}

// The instantiation for (dtype, width, vec), or null where there is none:
// vec is 1, 2 or 4.
KernelFn pick(int dtype, int width, int vec) {
  if (dtype == 0) {
    switch (vec) {
      case 1: return pick_width<float, 1>(width);
      case 2: return pick_width<float, 2>(width);
      case 4: return pick_width<float, 4>(width);
      default: return nullptr;
    }
  }
  if (dtype == 1) {
    switch (vec) {
      case 1: return pick_width<__nv_bfloat16, 1>(width);
      case 2: return pick_width<__nv_bfloat16, 2>(width);
      case 4: return pick_width<__nv_bfloat16, 4>(width);
      default: return nullptr;
    }
  }
  return nullptr;
}

}  // namespace

// C entry point.  x, state (may be null), w, bias and out are device
// pointers; dtype 0 = f32, 1 = bf16 (x, state and out); w_dtype and b_dtype
// the same codes for w and bias.  vec is the channels a thread moves at
// once: C must be a multiple of it and x, state and out aligned to vec
// elements.  Returns 0, -2 for what the kernel does not take (width
// outside 1..4, an unknown dtype or vec, seq beyond 2^31 - 2^16,
// channels beyond 2^31 / 36 or 2^31 warps or more), or the CUDA error of
// the launch (cudaGetLastError() right after it).
extern "C" int conv1d_launch(const void* x, const void* state, const void* w,
                             const void* bias, void* out, long long batch,
                             long long seq, long long channels, int width,
                             int tile_s, int dtype, int w_dtype, int b_dtype,
                             int vec, void* stream) {
  if (batch < 1 || seq < 1 || channels < 1 || tile_s < 1) return -2;
  if (width < 1 || width > kMaxWidth || channels % vec != 0) return -2;
  if ((w_dtype != 0 && w_dtype != 1) || (b_dtype != 0 && b_dtype != 1))
    return -2;
  if (seq + tile_s + kRun >= (1LL << 31) ||
      channels * (kRun + kMaxWidth) >= (1LL << 31))
    return -2;
  const KernelFn fn = pick(dtype, width, vec);
  if (fn == nullptr) return -2;
  const long long tile = tile_s < seq ? tile_s : seq;
  ConvParams P{};
  P.x = x;
  P.state = state;
  P.w = w;
  P.bias = bias;
  P.out = out;
  P.S = static_cast<int>(seq);
  P.C = static_cast<int>(channels);
  P.tile_s = static_cast<int>(tile);
  P.ntiles = static_cast<unsigned>((seq + tile - 1) / tile);
  P.runs = static_cast<unsigned>((tile + kRun - 1) / kRun);
  P.nslabs = static_cast<unsigned>((channels / vec + 31) / 32);
  P.w_dtype = w_dtype;
  P.b_dtype = b_dtype;
  const long long items = batch * P.ntiles * P.runs * P.nslabs;
  if (items >= (1LL << 31)) return -2;
  P.items = static_cast<unsigned>(items);
  const long long blocks = (items + kWarps - 1) / kWarps;
  void* args[] = {&P};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(fn), dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the (dtype, width, vec) instantiation resident on one SM, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (no dynamic shared
// memory); a negative value is the negated CUDA error, -2 an unknown
// instantiation.
extern "C" int conv1d_occupancy(int dtype, int width, int vec) {
  const KernelFn fn = pick(dtype, width, vec);
  if (fn == nullptr) return -2;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reinterpret_cast<const void*>(fn), kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
