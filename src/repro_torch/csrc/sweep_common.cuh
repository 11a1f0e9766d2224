// Device helpers shared by sweep_apply.cu and sweep_chain.cu: element
// conversion, the global-to-shared row copy into a window ring, and the
// per-step window pipeline (halo'd window at step 0, then one t_s-row
// slab per step, prefetched by cp.async one step ahead when pipelined).
//
// A params struct P passed to these helpers has the fields
//   in_stride[3] (element strides of the padded input), win[3] (window
//   extent per axis), sweep, c0, c1 (sweep and cross axes), rows (ring
//   depth in sweep rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;  // 227 KB: the most one block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// int8 holds quantized codes: the argument is already an integral value in
// [-128, 127] (quantize_code), so the conversion is exact.
template <>
__device__ __forceinline__ int8_t from_f32<int8_t>(float x) {
  return static_cast<int8_t>(__float2int_rn(x));
}

// One element from global to shared memory: cp.async for 4-byte types,
// an ordinary load and store for bf16 and int8 (cp.async has no 1- or
// 2-byte granule).
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  } else {
    *dst = *src;
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [g0, g0 + n) of the padded sweep axis, full window cross extents,
// into the ring slots g mod rows.
template <typename T, typename Params>
__device__ void load_rows(const Params& P, const T* src, T* ring,
                          long long g0, int n, long long base_c0,
                          long long base_c1) {
  const int w1 = P.win[P.c1];
  const int w0 = P.win[P.c0];
  const int plane = w0 * w1;
  const int total = n * plane;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int x1 = e % w1;
    const int t = e / w1;
    const int x0 = t % w0;
    const int r = t / w0;
    const long long g = g0 + r;
    const int slot = static_cast<int>(g % P.rows);
    const T* s = src + g * P.in_stride[P.sweep] +
                 (base_c0 + x0) * P.in_stride[P.c0] +
                 (base_c1 + x1) * P.in_stride[P.c1];
    copy_elem(ring + static_cast<long long>(slot) * plane + x0 * w1 + x1, s);
  }
}

// Bring the window ring up to date for sweep step k of nswp, so that it
// holds padded rows [k * t_s, k * t_s + t_s + h_s) when this returns.
// `load(g0, n)` issues the row copies of every ring.  Unpipelined, step
// k > 0 fetches its own slab after a barrier; pipelined, the ring has t_s
// spare rows and step k issues step k + 1's slab before computing, which
// the barrier at step k + 1 waits for.
template <typename Load>
__device__ __forceinline__ void window_step(int k, int nswp, int t_s,
                                            int h_s, int pipelined,
                                            Load&& load) {
  if (k == 0) {
    load(0LL, t_s + h_s);
    cp_commit();
    if (pipelined) {
      load(static_cast<long long>(t_s) + h_s, t_s);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
  } else if (pipelined) {
    cp_wait<0>();     // this step's slab, issued during the last step
    __syncthreads();  // ... visible to all, and the last step is done
    if (k + 1 < nswp) {
      load(static_cast<long long>(k + 1) * t_s + h_s, t_s);
      cp_commit();
    }
  } else {
    __syncthreads();  // the last step no longer reads the slots reused
    load(static_cast<long long>(k) * t_s + h_s, t_s);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  }
}

int align16(long long n) { return static_cast<int>((n + 15) / 16 * 16); }

}  // namespace
