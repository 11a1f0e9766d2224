// conv1d: causal depthwise convolution of width W followed by silu, over
// (B, S, C) channels-last activations (the Mamba2 block's conv).
//
// Replaces: src/repro/kernels/conv1d.py::_conv_call (line 44), its inner
//   `body` (line 54): out[b, s, c] = silu(acc), with acc built in f32 as
//   0 + x[s-W+1]*w[0] + ... + x[s]*w[W-1], then + bias, and stored in x's
//   dtype (f32 or bf16).  Rows before s = 0 come from `state` (B, W-1, C),
//   the previous sequence's tail, or are zero (_prepend_halo, line 124).
//
// What bounds it on an H100: bytes.  Per output element it reads one input
// and writes one output (2 + 2 bytes in bf16) and does 2W + 1 flops plus
// one exp, about 2 flops per byte against the card's ~20 f32 flops per
// byte of HBM bandwidth.  The least time is x read once plus out written
// once at 3.35 TB/s: 0.0526 ms for Mamba2-2.7B's prefill conv
// (4 x 2048 x 5376 bf16).
//
// What the design does about it: every input element is read from HBM
// about once.  The TPU kernel walks the sequence in order and shifts the
// W-1 halo rows inside VMEM from one sweep step to the next; a CUDA grid
// has neither order nor persistence, so here each block owns one
// (batch row, token tile, channel block), reads its own W-1 halo rows
// (from x before its tile, or from `state`), and each thread keeps the
// last W inputs of its channels in registers while it walks down its
// tile: the registers are the shifted window.  Threads map to channels,
// so every row load and store is coalesced along C; with C even and the
// buffers aligned, each thread owns two neighbouring channels and moves
// them as one float2 / bf16x2.  The ragged end of S is masked by the loop
// bound; there is no padding, and the result does not depend on tile_s.
//
// Bit-exactness: the multiply-adds are separate __fmul_rn / __fadd_rn in
// the reference's order (built with --fmad=false), and silu is
// acc * (1 / (1 + expf(-acc))), the form ATen's f32 sigmoid takes on the
// card, so the kernel equals the plain PyTorch version in kernels/conv1d.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWidth = 4;

struct ConvParams {
  const void* x;      // (B, S, C), f32 or bf16
  const void* state;  // (B, W-1, C) in x's dtype, or null for zeros
  const float* w;     // (W, C)
  const float* bias;  // (C,)
  void* out;          // (B, S, C) in x's dtype
  long long S;
  long long C;
  int tile_s;
};

__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = *p;
}
__device__ __forceinline__ void load(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[2]) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(t);
  v[1] = __high2float(t);
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// silu(a) = a * sigmoid(a), sigmoid written as ATen writes it for f32.
__device__ __forceinline__ float silu(float a) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
  return __fmul_rn(a, sig);
}

template <typename T, int W, int V>
__global__ void __launch_bounds__(kThreads)
    conv1d_silu_kernel(const __grid_constant__ ConvParams P) {
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (c0 >= P.C) return;
  const long long b = blockIdx.z;
  const long long s0 = static_cast<long long>(blockIdx.y) * P.tile_s;
  const long long s1 = min(s0 + P.tile_s, P.S);
  const T* x = static_cast<const T*>(P.x) + b * P.S * P.C + c0;
  T* out = static_cast<T*>(P.out) + b * P.S * P.C + c0;

  float w[W][V];
  float bias[V];
#pragma unroll
  for (int t = 0; t < W; ++t) load(P.w + t * P.C + c0, w[t]);
  load(P.bias + c0, bias);

  // win[t] holds input row s - (W-1) + t of the current output row s.
  float win[W][V];
#pragma unroll
  for (int t = 0; t < W - 1; ++t) {
    const long long r = s0 - (W - 1) + t;
    if (r >= 0) {
      load(x + r * P.C, win[t]);
    } else if (P.state != nullptr) {
      const T* st = static_cast<const T*>(P.state) +
                    (b * (W - 1) + (W - 1) + r) * P.C + c0;
      load(st, win[t]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) win[t][v] = 0.0f;
    }
  }

#pragma unroll 4
  for (long long s = s0; s < s1; ++s) {
    load(x + s * P.C, win[W - 1]);
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < W; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(win[t][v], w[t][v]));
      }
      o[v] = silu(__fadd_rn(acc, bias[v]));
    }
    store(out + s * P.C, o);
#pragma unroll
    for (int t = 0; t < W - 1; ++t) {
#pragma unroll
      for (int v = 0; v < V; ++v) win[t][v] = win[t + 1][v];
    }
  }
}

template <typename T, int W, int V>
int launch(const ConvParams& P, long long batch, long long tiles,
           cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * V;
  const dim3 grid(static_cast<unsigned>((P.C + per_block - 1) / per_block),
                  static_cast<unsigned>(tiles),
                  static_cast<unsigned>(batch));
  conv1d_silu_kernel<T, W, V><<<grid, kThreads, 0, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_width(const ConvParams& P, int width, long long batch,
                 long long tiles, cudaStream_t stream) {
  switch (width) {
    case 1: return launch<T, 1, V>(P, batch, tiles, stream);
    case 2: return launch<T, 2, V>(P, batch, tiles, stream);
    case 3: return launch<T, 3, V>(P, batch, tiles, stream);
    case 4: return launch<T, 4, V>(P, batch, tiles, stream);
    default: return -2;
  }
}

template <typename T>
int launch_vec(const ConvParams& P, int width, int vec, long long batch,
               long long tiles, cudaStream_t stream) {
  return vec == 2 ? launch_width<T, 2>(P, width, batch, tiles, stream)
                  : launch_width<T, 1>(P, width, batch, tiles, stream);
}

}  // namespace

// C entry point.  x, state (may be null), w, bias and out are device
// pointers; dtype 0 = f32, 1 = bf16 (x, state and out); w and bias are f32.
// vec = 2 asks for paired channels (C even, buffers aligned to a pair).
// Returns 0, -2 for a shape the kernel does not take (width outside 1..4,
// a grid dimension too large, vec 2 with C odd), or the CUDA error code of
// the launch (cudaGetLastError() right after it).
extern "C" int conv1d_launch(const void* x, const void* state, const void* w,
                             const void* bias, void* out, long long batch,
                             long long seq, long long channels, int width,
                             int tile_s, int dtype, int vec, void* stream) {
  if (batch < 1 || seq < 1 || channels < 1 || tile_s < 1) return -2;
  if (width < 1 || width > kMaxWidth) return -2;
  if (vec != 1 && !(vec == 2 && channels % 2 == 0)) return -2;
  const long long tiles = (seq + tile_s - 1) / tile_s;
  if (tiles > 65535 || batch > 65535) return -2;
  ConvParams P{};
  P.x = x;
  P.state = state;
  P.w = static_cast<const float*>(w);
  P.bias = static_cast<const float*>(bias);
  P.out = out;
  P.S = seq;
  P.C = channels;
  P.tile_s = tile_s;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch_vec<__nv_bfloat16>(P, width, vec, batch, tiles, s);
  }
  if (dtype == 0) return launch_vec<float>(P, width, vec, batch, tiles, s);
  return -2;
}
