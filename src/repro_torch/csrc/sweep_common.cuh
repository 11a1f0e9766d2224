// Device helpers shared by sweep_apply.cu and sweep_chain.cu: element
// conversion, float-reciprocal division (FastDiv), the global-to-shared
// row copies of the window rings, and the per-step window pipeline
// (halo'd window at step 0, then one t_s-row slab per step, prefetched by
// cp.async one step ahead when pipelined).  Two row-copy families:
// sweep_chain.cu's (load_rows_wide: 16-byte blocks where a row's source
// and shared start share their alignment, else element by element;
// load_rows where the rows are not contiguous) and sweep_apply.cu's
// (load_rows_pitched: shared rows padded to their source's alignment,
// copied as 16/8/4/2-byte pieces, with what lies outside the input
// zero-filled).  The second does all the first does; moving the chain
// onto it is listed in ROADMAP.md.
//
// A params struct P passed to these helpers has the fields
//   in_stride[3] (element strides of the input), win[3] (window
//   extent per axis), rows (ring depth in sweep rows); load_rows and
//   load_rows_wide also read sweep, c0, c1 (sweep and cross axes) and
//   load_rows_wide copy16; load_rows_pitched reads copy16, head, tail,
//   span, pitch, plane, group, n[3] (the input's extents) and org[3] (the
//   window coordinate of the input's element 0).

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// One contiguous run of `len` elements from global to shared memory by one
// warp: 16-byte cp.async.cg blocks where source and destination share
// their alignment modulo 16, the unaligned ends (or the whole run, where
// the two alignments differ) element by element through copy_elem.
template <typename T>
__device__ __forceinline__ void copy_run(T* dst, const T* src, int len,
                                         int lane) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const unsigned long long sa = reinterpret_cast<unsigned long long>(src);
  const unsigned da =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int head = len, nblk = 0;
  if (((sa ^ da) & 15u) == 0) {
    head = min(len, static_cast<int>(((16u - (sa & 15u)) & 15u) /
                                     sizeof(T)));
    nblk = (len - head) / kPer;
  }
  const int body_end = head + nblk * kPer;
  const int units = head + nblk + (len - body_end);
  for (int u = lane; u < units; u += 32) {
    if (u < head) {
      copy_elem(dst + u, src + u);
    } else if (u < head + nblk) {
      const int e = head + (u - head) * kPer;
      cp_async16(dst + e, src + e);
    } else {
      const int e = body_end + (u - head - nblk);
      copy_elem(dst + e, src + e);
    }
  }
}

// Exact quotient and remainder of 0 <= e < 2^22 by d >= 1, from a float
// estimate corrected once (the estimate is within 1/2 of e / d there):
// a few instructions where an int division takes a software routine.
struct FastDiv {
  int d;
  float inv;
};
__device__ __forceinline__ FastDiv make_div(int d) {
  return {d, __frcp_rn(static_cast<float>(d))};
}
__device__ __forceinline__ int divide(int e, const FastDiv& f, int& rem) {
  int q = __float2int_rz(__fmul_rn(__int2float_rn(e), f.inv));
  int r = e - q * f.d;
  if (r < 0) {
    --q;
    r += f.d;
  } else if (r >= f.d) {
    ++q;
    r -= f.d;
  }
  rem = r;
  return q;
}

// load_rows with the rows copied as 16-byte cp.async.cg blocks.  Where the
// whole launch is aligned (P.copy16: the input's base, sweep and c0 strides,
// the tile's c1 extent and the window's c1 row all multiples of 16 bytes,
// c1 the minor axis), each thread copies whole blocks of a flat index over
// (row, c0, block); otherwise, with c1 the minor axis, one warp copies each
// contiguous row through copy_run; else element by element (load_rows).
template <typename T, typename Params>
__device__ void load_rows_wide(const Params& P, const T* src, T* ring,
                               long long g0, int n, long long base_c0,
                               long long base_c1) {
  const int w1 = P.win[P.c1];
  const int w0 = P.win[P.c0];
  const int plane = w0 * w1;
  const int slot0 = static_cast<int>(g0 % P.rows);
  const T* base = src + g0 * P.in_stride[P.sweep] +
                  base_c0 * P.in_stride[P.c0] + base_c1;
  if (P.copy16) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    const int nb = w1 / kPer;
    const FastDiv per_row = make_div(w0 * nb), per_run = make_div(nb);
    for (int u = threadIdx.x; u < n * w0 * nb; u += blockDim.x) {
      int rem, b;
      const int r = divide(u, per_row, rem);
      const int x0 = divide(rem, per_run, b);
      int slot = slot0 + r;
      if (slot >= P.rows) slot -= P.rows;
      cp_async16(ring + slot * plane + x0 * w1 + b * kPer,
                 base + r * P.in_stride[P.sweep] + x0 * P.in_stride[P.c0] +
                     b * kPer);
    }
    return;
  }
  if (P.in_stride[P.c1] != 1) {
    load_rows(P, src, ring, g0, n, base_c0, base_c1);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const FastDiv per_row = make_div(w0);
  for (int run = threadIdx.x >> 5; run < n * w0; run += nwarps) {
    int x0;
    const int r = divide(run, per_row, x0);
    int slot = slot0 + r;
    if (slot >= P.rows) slot -= P.rows;
    copy_run(ring + slot * plane + x0 * w1,
             base + r * P.in_stride[P.sweep] + x0 * P.in_stride[P.c0], w1,
             lane);
  }
}

// Copy `bytes` (2, 4, 8 or 16) from global to shared memory: cp.async for
// 4 bytes and more, an ordinary load and store for 2.
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                          const unsigned char* src,
                                          unsigned bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    *reinterpret_cast<unsigned short*>(dst) =
        *reinterpret_cast<const unsigned short*>(src);
  }
}

// One contiguous run of `len` elements from global to shared memory by a
// group of `group` lanes (`lane` in [0, group)), in the widest granule G
// (16, 8, 4 or 2 bytes) at which source and destination share their
// alignment: the bytes before the first G boundary as aligned pieces
// lowest first, whole granules, then the rest as aligned pieces largest
// first, one unit a lane in turn.  A run shorter than two granules goes
// element by element.  (copy_run with any alignment and group width.)
template <typename T>
__device__ __forceinline__ void copy_run_pieces(T* dst, const T* src,
                                                int len, int lane,
                                                int group) {
  constexpr unsigned kEs = sizeof(T);
  const unsigned long long sa = reinterpret_cast<unsigned long long>(src);
  const unsigned da = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned diff = static_cast<unsigned>(sa) ^ da;
  const unsigned g = (diff & 15u) == 0   ? 16u
                     : (diff & 7u) == 0  ? 8u
                     : (diff & 3u) == 0  ? 4u
                                         : 2u;
  const unsigned bytes = static_cast<unsigned>(len) * kEs;
  unsigned head = (g - static_cast<unsigned>(sa & (g - 1))) & (g - 1);
  if (g <= kEs || bytes < head + 2 * g) {
    for (int e = lane; e < len; e += group)
      copy_piece(reinterpret_cast<unsigned char*>(dst + e),
                 reinterpret_cast<const unsigned char*>(src + e), kEs);
    return;
  }
  const unsigned nblk = (bytes - head) / g;
  const unsigned tail = bytes - head - nblk * g;
  const int nh = __popc(head), nt = __popc(tail);
  const int units = nh + static_cast<int>(nblk) + nt;
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  for (int u = lane; u < units; u += group) {
    unsigned at, size;
    if (u < nh) {  // the u-th lowest set bit of head
      unsigned h = head;
      for (int k = 0; k < u; ++k) h &= h - 1;
      size = h & (0u - h);
      at = head & (size - 1);
    } else if (u < nh + static_cast<int>(nblk)) {
      size = g;
      at = head + static_cast<unsigned>(u - nh) * g;
    } else {  // the j-th highest set bit of tail
      unsigned t = tail;
      for (int k = 0; k < u - nh - static_cast<int>(nblk); ++k)
        t &= ~(1u << (31 - __clz(t)));
      size = 1u << (31 - __clz(t));
      at = head + nblk * g + (tail & ~((size << 1) - 1));
    }
    copy_piece(d + at, s + at, size);
  }
}

// Copy `bytes` (4, 8 or 16) from global to shared memory by cp.async, of
// which the first `valid` come from src and the rest are zeros (the
// src-size operand); with valid 0 nothing is read, but src must still be
// a mapped address aligned to `bytes`.
__device__ __forceinline__ void copy_zfill(unsigned char* dst,
                                          const unsigned char* src,
                                          unsigned bytes, unsigned valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid));
  }
}

// load_rows_wide for a ring whose window rows lie P.pitch elements apart
// along c0 and whose slots lie P.plane elements apart, with the axes
// (kS sweep, kC0 < kC1 cross) and the block's kThreads threads known at
// compile time.  Window coordinates are the tile's plus the halo: the
// input's element 0 sits at window coordinate P.org (zero for a padded
// buffer, the halo lo where the input is the caller's grid), and every
// element outside the input's extents P.n reads as zero.
//
// Where P.copy16 (the input's base, sweep and c0 strides and the tile's
// c1 extent all multiples of 16 bytes, c1 the minor axis, and each window
// row a P.head-byte piece, whole 16-byte blocks and a P.tail-byte piece,
// pieces of 0, 4 or 8 bytes), each thread copies one 16-byte block of a
// flat index over (row, c0, block): with P.span every block the row
// touches (the shared row has the room), else its whole blocks and then
// one end piece a thread of a flat index over (row, c0, end).  A block or
// piece outside the input is zero-filled by cp.async with a src-size of 0
// from the input's base, one across its c1 end with the bytes inside.
// Else, with c1 the minor axis, a group of P.group lanes (a power of two
// dividing 32) copies each row's part inside the input through
// copy_run_pieces, so a row reaches 16-byte blocks whenever its shared
// start shares its source's address modulo 16, and stores zeros around
// it; else element by element, sweep rows fastest so that neighbouring
// threads read neighbouring elements.
template <int kThreads, int kS, int kC0, int kC1, typename T,
          typename Params>
__device__ void load_rows_pitched(const Params& P, const T* src, T* ring,
                                  long long g0, int n, int base_c0,
                                  int base_c1) {
  constexpr int kEs = static_cast<int>(sizeof(T));
  const int w1 = P.win[kC1];
  const int w0 = P.win[kC0];
  const int slot0 = static_cast<int>(g0 % P.rows);
  const long long ss = P.in_stride[kS];
  const long long s0 = P.in_stride[kC0];
  // Input coordinates of the first window element of these rows.
  const int i_s = static_cast<int>(g0) - P.org[kS];
  const int i_0 = base_c0 - P.org[kC0];
  const int i_1 = base_c1 - P.org[kC1];
  const auto row_in = [&](int r, int x0) {
    return static_cast<unsigned>(i_s + r) <
               static_cast<unsigned>(P.n[kS]) &&
           static_cast<unsigned>(i_0 + x0) < static_cast<unsigned>(P.n[kC0]);
  };
  if (P.copy16) {
    // A row is P.head bytes up to its first 16-byte boundary, whole
    // blocks, then P.tail bytes.  Where its shared row has room (P.span),
    // every block the row touches is copied, the end pieces with the
    // neighbours that share their blocks (never read); else its whole
    // blocks, and the end pieces in a second, small loop.  The blocks of
    // a call whose rows all lie inside the input copy unchecked.
    constexpr int kPer = 16 / kEs;
    const int pre = (16 - P.head) % 16, post = (16 - P.tail) % 16;
    const int lead = P.span ? -pre / kEs : P.head / kEs;  // first block
    const int nb = P.span ? (pre + w1 * kEs + post) / 16
                          : (w1 * kEs - P.head - P.tail) / 16;
    const int c_first = i_1 + lead;  // input column of a row's first block
    const FastDiv per_row = make_div(w0 * nb), per_run = make_div(nb);
    T* const dst0 = ring + lead;
    if (i_s >= 0 && i_s + n <= P.n[kS] && i_0 >= 0 &&
        i_0 + w0 <= P.n[kC0] && c_first >= 0 &&
        c_first + nb * kPer <= P.n[kC1]) {
      const T* base = src + i_s * ss + i_0 * s0 + c_first;
      const int ssi = static_cast<int>(ss), s0i = static_cast<int>(s0);
      for (int u = threadIdx.x; u < n * w0 * nb; u += kThreads) {
        int rem, b;
        const int r = divide(u, per_row, rem);
        const int x0 = divide(rem, per_run, b);
        int slot = slot0 + r;
        if (slot >= P.rows) slot -= P.rows;
        cp_async16(dst0 + slot * P.plane + x0 * P.pitch + b * kPer,
                   base + static_cast<long long>(r) * ssi + x0 * s0i +
                       b * kPer);
      }
    } else {
      for (int u = threadIdx.x; u < n * w0 * nb; u += kThreads) {
        int rem, b;
        const int r = divide(u, per_row, rem);
        const int x0 = divide(rem, per_run, b);
        int slot = slot0 + r;
        if (slot >= P.rows) slot -= P.rows;
        const int c = c_first + b * kPer;
        const bool in = row_in(r, x0) && c >= 0 && c < P.n[kC1];
        copy_zfill(
            reinterpret_cast<unsigned char*>(dst0 + slot * P.plane +
                                             x0 * P.pitch + b * kPer),
            reinterpret_cast<const unsigned char*>(
                in ? src + (i_s + r) * ss + (i_0 + x0) * s0 + c : src),
            16, in ? min(16, (P.n[kC1] - c) * kEs) : 0);
      }
    }
    if (!P.span && (P.head | P.tail)) {
      const FastDiv per_row2 = make_div(2 * w0);
      for (int u = threadIdx.x; u < n * w0 * 2; u += kThreads) {
        int rem;
        const int r = divide(u, per_row2, rem);
        const int x0 = rem >> 1;
        const int size = rem & 1 ? P.tail : P.head;
        if (size == 0) continue;
        const int at = rem & 1 ? lead + nb * kPer : 0;  // within the row
        int slot = slot0 + r;
        if (slot >= P.rows) slot -= P.rows;
        const int c = i_1 + at;
        const bool in = row_in(r, x0) && c >= 0 && c < P.n[kC1];
        copy_zfill(
            reinterpret_cast<unsigned char*>(ring + slot * P.plane +
                                             x0 * P.pitch + at),
            reinterpret_cast<const unsigned char*>(
                in ? src + (i_s + r) * ss + (i_0 + x0) * s0 + c : src),
            size, in ? min(size, (P.n[kC1] - c) * kEs) : 0);
      }
    }
    return;
  }
  const T zero = from_f32<T>(0.0f);
  if (P.in_stride[kC1] == 1) {
    const int lane = threadIdx.x & (P.group - 1);
    const int shift = __ffs(P.group) - 1;
    const FastDiv per_row = make_div(w0);
    // The window columns inside the input, [j0, j1).
    const int j0 = min(w1, max(0, -i_1));
    const int j1 = max(j0, min(w1, P.n[kC1] - i_1));
    for (int run = threadIdx.x >> shift; run < n * w0;
         run += kThreads >> shift) {
      int x0;
      const int r = divide(run, per_row, x0);
      int slot = slot0 + r;
      if (slot >= P.rows) slot -= P.rows;
      T* dst = ring + slot * P.plane + x0 * P.pitch;
      const bool in = row_in(r, x0);
      const int a = in ? j0 : 0, b = in ? j1 : 0;  // copied: [a, b)
      for (int e = lane; e < w1 - (b - a); e += P.group)
        dst[e < a ? e : e + (b - a)] = zero;
      if (b > a)
        copy_run_pieces(dst + a,
                        src + (i_s + r) * ss + (i_0 + x0) * s0 + i_1 + a,
                        b - a, lane, P.group);
    }
    return;
  }
  const long long s1 = P.in_stride[kC1];
  const FastDiv by_n = make_div(n), by_w1 = make_div(w1);
  for (int u = threadIdx.x; u < n * w0 * w1; u += kThreads) {
    int r, x1;
    const int t = divide(u, by_n, r);
    const int x0 = divide(t, by_w1, x1);
    int slot = slot0 + r;
    if (slot >= P.rows) slot -= P.rows;
    T* dst = ring + slot * P.plane + x0 * P.pitch + x1;
    if (row_in(r, x0) &&
        static_cast<unsigned>(i_1 + x1) < static_cast<unsigned>(P.n[kC1]))
      copy_elem(dst,
                src + (i_s + r) * ss + (i_0 + x0) * s0 + (i_1 + x1) * s1);
    else
      *dst = zero;
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
