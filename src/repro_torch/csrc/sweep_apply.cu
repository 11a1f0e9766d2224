// sweep_apply: one stencil application over p RHS arrays, swept along one
// axis with the window overlap kept in shared memory.
//
// Replaces: src/repro/kernels/stencil.py::_sweep_kernel (line 148), parts
//   B1 (window pipeline: halo'd window at the first sweep step, then only
//   the new t_s-row slab, the trailing h_s rows reused) and B2 (the
//   single-application body q = sum_p sum_taps w * u_p[x + o], f32
//   accumulation, stored at the input dtype).
//
// What bounds it on an H100: bytes.  A 13-point star does 26 flops per
// output point against 8 bytes of f32 traffic (one read, one write), about
// 3 flops per byte, far below the card's ~20 f32 flops per byte of HBM
// bandwidth (67 TFLOP/s over 3.35 TB/s).  The least time is the inputs
// read once plus the output written once at 3.35 TB/s.  What is left per
// tap and output once the window is in shared memory is one shared load
// (shared between taps where they read the same element), one multiply
// and one add; the design keeps everything else off that path.
//
// What the design does about it:
// * One CTA owns one cross-axis tile column and loops over its nswp sweep
//   steps itself (a CUDA grid has no order and no persistent scratch,
//   unlike the TPU grid); the sweep-axis overlap of consecutive windows
//   stays in one shared-memory ring per RHS indexed modulo its depth, so a
//   step fetches only its new t_s rows.  With `pipelined`, the ring has
//   t_s spare rows and the next slab arrives by cp.async while the
//   current step computes (window_step, sweep_common.cuh).
// * 512 threads a CTA (kThreads, APPLY_THREADS in kernels/sweep.py), at
//   most 64 registers a thread so that two CTAs share an SM.  A thread
//   owns kRows = 4 consecutive sweep rows at one cross position:
//   each source row's shared offset is found once per item, and the four
//   sums are in flight together.  Index arithmetic is int32; the item's
//   (row block, c0, c1) comes from float-reciprocal divisions (FastDiv),
//   and the ring slot of a step's first row is kept from step to step.
//   The kernel is built per sweep axis, so every per-axis parameter is
//   read at a constant index.
// * The 7- and 13-point stars and the 27-point box
//   (core/cache_fitting.py::star_stencil order, and itertools.product
//   order) are compiled with constant offsets for each sweep axis (the
//   kernel is built once per sweep axis), so any RHS whose taps are one of
//   them runs without per-tap dispatch.  Any other operator runs a
//   table-driven loop whose taps (sweep and plane offsets packed in one
//   int, and the weight: one 8-byte parameter read) are read a tap ahead.
// * The kernel reads the caller's grid as it is: no zero-haloed copy of
//   it is made before the launch.  A window is laid over the grid at the
//   tile's base less the halo lo, and every part of it outside the grid
//   (the halo at the grid's faces, the round-up of a last tile) is
//   zero-filled in shared memory as it arrives, so a tap that reads there
//   adds w * 0 as it would from a stored zero.  Outputs past the grid are
//   neither computed nor stored, so the output has the grid's own shape.
//   A padded launch buffer (the sharded path's) is read the same way, as
//   a grid that is the whole buffer.
// * Window rows arrive as cp.async copies of 16 bytes where they can.
//   Each shared row starts at its source row's address modulo 16: the row
//   pitch is padded to the source's c0 pitch modulo 16 bytes and each RHS
//   ring starts at its first source element's offset modulo 16.  So a bf16
//   grid whose rows alternate between 16-byte and 8-byte alignment (a
//   260-element padded row) still copies whole 16-byte blocks, with 8- or
//   4-byte cp.async pieces at the ends; only a 2-byte end piece is copied
//   by an ordinary load and store; a row takes a group of 4 to 32 lanes,
//   as many as its pieces need.  Where the whole launch is aligned, each
//   thread copies one 16-byte block of a flat index (copy16).  On the
//   caller's grid a window row starts 1 or 2 f32 before a 16-byte
//   boundary (the halo lo), so it is an end piece, whole blocks and an end
//   piece: where the wrapper widens the shared rows to make room
//   (row_pad, kernels/sweep.py::_row_pad: only where two CTAs still fit an
//   SM), every block the row touches is copied, the pieces with the
//   neighbours that share their blocks (never read); else the pieces
//   follow as cp.async copies of their own, which cost more (each is a
//   line of its own).  A block outside the grid is a cp.async with a
//   src-size of 0 from the grid's base.  When the sweep axis is the minor
//   one, elements are copied one by one, with the sweep rows fastest so
//   the reads coalesce (load_rows_pitched, sweep_common.cuh).
//
// * bf16 launches take a pair loop where they can (P.pair): each thread
//   owns two neighbouring outputs along c1, (x1, x1 + 1) with x1 even,
//   over kPairRows = 4 sweep rows, so a warp's item reads and writes 128
//   contiguous bytes.  A row's taps read 32-bit words of two bf16 from
//   shared memory, unpacked to f32 by a shift or a mask (exact, as
//   __bfloat162float is): the centre pair, which the sweep and c0 taps
//   read at their rows, and the words (x1 - 2, x1 - 1) and (x1 + 2,
//   x1 + 3) for the c1 taps, so a 13-point row takes 8 words where the
//   element loop takes 16 loads.  The two sums go out as one 32-bit
//   store where every output pair sits on a 4-byte word and this one
//   lies inside the grid, else element by element (the last output of an
//   odd c1 extent alone).  The launcher sets P.pair (and returns
//   kRowsPair) where the dtype is bf16, c1 is the minor axis at sweep
//   axis 0 or 1, the tile's c1 extent is even, every output pair lands on
//   a 4-byte word of each ring (the inputs' bases, their c0 stride and
//   the window's lo) and every RHS is a compiled shape; any other launch
//   runs the element loop.  A word's unused half may lie one element
//   past a window row, inside the ring's 16 bytes of slack.
//
// Bit-exactness: each output's taps are applied RHS by RHS in
// zip(offsets, weights) order as separate f32 multiplies and adds (built
// with --fmad=false) into one sum from zero, so the result equals the plain
// PyTorch version in kernels/sweep.py bit for bit.

#include <cstring>
#include <initializer_list>

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 512;  // = APPLY_THREADS in kernels/sweep.py
constexpr int kRows = 4;       // sweep rows per thread (register block)
constexpr int kReach = 2;      // sweep offsets read through row offsets
constexpr int kSpan = kRows + 2 * kReach;  // source rows those can read
constexpr int kPairRows = 4;  // sweep rows per thread in the pair loop
constexpr int kPairSpan = kPairRows + 2 * kReach;
constexpr int kMaxRhs = 8;
constexpr int kMaxTaps = 192;
// sweep_apply_launch's return on success: the row path it set up.
constexpr int kRowsCopy16 = 1;  // = _ROWS_COPY16 in kernels/sweep.py
constexpr int kRowsSpan = 2;    // = _ROWS_SPAN
constexpr int kRowsPair = 4;    // = _ROWS_PAIR
// A failed launch returns -kCudaErrorBase less its CUDA error.
constexpr int kCudaErrorBase = 16;  // = _CUDA_ERROR_BASE

struct ApplyParams {
  const void* in[kMaxRhs];
  void* out;
  long long in_stride[3];   // element strides of the inputs
  long long out_stride[3];  // element strides of the output
  int tile[3];
  int lo[3];   // window halo below the tile, per axis
  int win[3];  // window extent tile + lo + hi, per axis
  int n[3];      // the inputs' extents: what lies outside reads as zero
  int org[3];    // window coordinate of the inputs' element 0 (lo or 0)
  int out_n[3];  // the output's extents: rows past them are not stored
  int nswp;           // sweep steps per column
  int ntiles_c1;      // tile columns along c1 (decodes blockIdx.x)
  int rows;           // ring depth in sweep rows
  int h_s;            // sweep-axis window halo lo + hi
  int pipelined;
  int p;
  int pitch;       // shared elements between window rows along c0
  int plane;       // shared elements between ring slots (16-byte multiple)
  int ring_bytes;  // bytes between consecutive RHS rings (16-aligned)
  int copy16;      // every window row copies by the flat index (units)
  int head, tail;  // bytes of a row's piece before / after its blocks
  int span;        // copy16 rows copy every block they touch (row_pad)
  int group;       // lanes copying one window row otherwise (4 to 32)
  int tap_begin[kMaxRhs + 1];
  int shape[kMaxRhs];  // kShapeTable or the compiled shape of RHS a's taps
  // Per tap: the sweep offset (ring rows, top 8 bits) and the offset
  // within a window plane (c0 * pitch + c1; low 24 bits), then the
  // weight's bits.
  int2 tap[kMaxTaps];
  int pair;  // bf16 only: two neighbouring c1 outputs a thread
};
static_assert(sizeof(ApplyParams) <= 4096, "ApplyParams exceeds 4 KB");

// Compiled operator shapes, each tap's offset per axis of the 3-D lifted
// grid: the 7- and 13-point stars (star_stencil order: the origin, then
// per axis -1, +1, -2, +2) and the 27-point box (itertools.product order).
constexpr int kShapeTable = 0, kStar1 = 1, kStar2 = 2, kBox1 = 3;

__host__ __device__ constexpr int shape_taps(int shape) {
  return shape == kStar1 ? 7 : (shape == kStar2 ? 13 : 27);
}

__host__ __device__ constexpr int shape_axis_off(int shape, int t, int a) {
  if (shape == kBox1)
    return (a == 0 ? t / 9 : (a == 1 ? t / 3 % 3 : t % 3)) - 1;
  const int reach = shape == kStar1 ? 1 : 2;
  if (t == 0) return 0;
  const int u = t - 1;
  const int k = u % (2 * reach) / 2 + 1;
  return u / (2 * reach) == a ? (u % 2 ? k : -k) : 0;
}

// The grid axis that plays role r (0 sweep, 1 c0, 2 c1) at sweep axis sw.
__host__ __device__ constexpr int role_axis(int sw, int r) {
  return r == 0 ? sw : (r == 1 ? (sw == 0 ? 1 : 0) : (sw == 2 ? 1 : 2));
}

// One compiled RHS: its taps added to the kRows sums in order.  off[k] is
// the shared offset of the source row k - kReach rows from the thread's
// first row, at the thread's cross position.
template <int SH, int SW, typename T>
__device__ __forceinline__ void shape_add(const ApplyParams& P, int q0,
                                          const T* ring, int pitch,
                                          const int (&off)[kSpan],
                                          float (&acc)[kRows]) {
#pragma unroll
  for (int t = 0; t < shape_taps(SH); ++t) {
    const int os = shape_axis_off(SH, t, role_axis(SW, 0));
    const int c = shape_axis_off(SH, t, role_axis(SW, 1)) * pitch +
                  shape_axis_off(SH, t, role_axis(SW, 2));
    const float w = __int_as_float(P.tap[q0 + t].y);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      acc[i] = __fadd_rn(
          acc[i], __fmul_rn(w, to_f32(ring[off[i + os + kReach] + c])));
  }
}

template <int OS, typename T>
__device__ __forceinline__ void tap_rows(const T* ring,
                                         const int (&off)[kSpan], int c,
                                         float w, float (&acc)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    acc[i] = __fadd_rn(acc[i],
                       __fmul_rn(w, to_f32(ring[off[i + OS + kReach] + c])));
}

// Any other RHS: its taps from the parameter bank, each read a tap ahead;
// sweep offsets beyond kReach wrap each row's slot (m: the thread's first
// row's slot, cross: its cross position).
template <typename T>
__device__ __forceinline__ void table_add(const ApplyParams& P, int q0,
                                          int q1, const T* ring,
                                          const int (&off)[kSpan], int m,
                                          int cross, float (&acc)[kRows]) {
  int2 next = P.tap[q0];
  for (int q = q0; q < q1; ++q) {
    const int2 t = next;
    if (q + 1 < q1) next = P.tap[q + 1];
    const int os = t.x >> 24;
    const int c = (t.x << 8) >> 8;
    const float w = __int_as_float(t.y);
    if (os == 0) {
      tap_rows<0>(ring, off, c, w, acc);
    } else if (os == -1) {
      tap_rows<-1>(ring, off, c, w, acc);
    } else if (os == 1) {
      tap_rows<1>(ring, off, c, w, acc);
    } else if (os == -2) {
      tap_rows<-2>(ring, off, c, w, acc);
    } else if (os == 2) {
      tap_rows<2>(ring, off, c, w, acc);
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        int s = m + os + i;
        while (s < 0) s += P.rows;
        while (s >= P.rows) s -= P.rows;
        acc[i] = __fadd_rn(
            acc[i], __fmul_rn(w, to_f32(ring[s * P.plane + cross + c])));
      }
    }
  }
}

// Element e (-2 to 3) of a pair row, from the word (2 bf16) that holds
// it: row points at the pair's first element, on a 4-byte word.  A bf16
// is the top half of an f32, so the low element is the word shifted up
// and the high one its top half.
__device__ __forceinline__ float pair_elem(const __nv_bfloat16* row, int e) {
  const unsigned w = *reinterpret_cast<const unsigned*>(row + (e & ~1));
  return __uint_as_float(e & 1 ? w & 0xFFFF0000u : w << 16);
}

// shape_add for the pair loop: each tap added to the sums of both
// outputs, acc0 at x1 and acc1 at x1 + 1, in order.
template <int SH, int SW>
__device__ __forceinline__ void shape_add_pair(const ApplyParams& P, int q0,
                                               const __nv_bfloat16* ring,
                                               int pitch,
                                               const int (&off)[kPairSpan],
                                               float (&acc0)[kPairRows],
                                               float (&acc1)[kPairRows]) {
#pragma unroll
  for (int t = 0; t < shape_taps(SH); ++t) {
    const int os = shape_axis_off(SH, t, role_axis(SW, 0));
    const int d0 = shape_axis_off(SH, t, role_axis(SW, 1));
    const int d1 = shape_axis_off(SH, t, role_axis(SW, 2));
    const float w = __int_as_float(P.tap[q0 + t].y);
#pragma unroll
    for (int i = 0; i < kPairRows; ++i) {
      const __nv_bfloat16* row = ring + off[i + os + kReach] + d0 * pitch;
      acc0[i] = __fadd_rn(acc0[i], __fmul_rn(w, pair_elem(row, d1)));
      acc1[i] = __fadd_rn(acc1[i], __fmul_rn(w, pair_elem(row, d1 + 1)));
    }
  }
}

// RHS a's ring in shared memory, offset by the address modulo 16 of its
// window's first element (`first` elements from the input's element 0;
// negative where the window starts before the grid).
template <typename T>
__device__ __forceinline__ T* ring_of(const ApplyParams& P,
                                      unsigned char* smem, int a,
                                      long long first) {
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(P.in[a]) +
      static_cast<unsigned long long>(first) * sizeof(T);
  return reinterpret_cast<T*>(smem + a * P.ring_bytes +
                              static_cast<int>(addr & 15));
}

// One sweep step of the pair loop (P.pair): items of two outputs along
// c1 over kPairRows sweep rows, the pair index fastest; m0 and the rest
// as the element loop of sweep_apply_kernel has them.
template <int SW>
__device__ __forceinline__ void pair_step(const ApplyParams& P,
                                          unsigned char* smem,
                                          long long first, int g_step,
                                          int base_c0, int base_c1, int m0) {
  constexpr int kS = role_axis(SW, 0), kC0 = role_axis(SW, 1),
                kC1 = role_axis(SW, 2);
  const int t_s = P.tile[kS];
  const int half = P.tile[kC1] / 2;
  const int n_items =
      (t_s + kPairRows - 1) / kPairRows * P.tile[kC0] * half;
  const FastDiv by_plane = make_div(P.tile[kC0] * half),
                by_half = make_div(half);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(P.out);
  // Whether every output pair sits on a 4-byte word (x1 is even).
  const bool words = (reinterpret_cast<unsigned long long>(out) & 3) == 0 &&
                     P.out_stride[kS] % 2 == 0 && P.out_stride[kC0] % 2 == 0;
  for (int u = threadIdx.x; u < n_items; u += kThreads) {
    int rem, xp;
    const int c = divide(u, by_plane, rem);
    const int x0 = divide(rem, by_half, xp);
    const int x1 = 2 * xp;
    if (base_c0 + x0 >= P.out_n[kC0] || base_c1 + x1 >= P.out_n[kC1])
      continue;  // past the grid: nothing to compute or store
    const int rows = P.rows;
    int m = m0 + c * kPairRows;
    while (m >= rows) m -= rows;
    const int cross = (x0 + P.lo[kC0]) * P.pitch + x1 + P.lo[kC1];
    int off[kPairSpan];
    int slot = m - kReach;
    while (slot < 0) slot += rows;
#pragma unroll
    for (int j = 0; j < kPairSpan; ++j) {
      off[j] = slot * P.plane + cross;
      slot = slot + 1 == rows ? 0 : slot + 1;
    }
    float acc0[kPairRows], acc1[kPairRows];
#pragma unroll
    for (int i = 0; i < kPairRows; ++i) acc0[i] = acc1[i] = 0.0f;
    for (int a = 0; a < P.p; ++a) {
      const __nv_bfloat16* ring = ring_of<__nv_bfloat16>(P, smem, a, first);
      const int q0 = P.tap_begin[a];
      switch (P.shape[a]) {
        case kStar2:
          shape_add_pair<kStar2, SW>(P, q0, ring, P.pitch, off, acc0, acc1);
          break;
        case kStar1:
          shape_add_pair<kStar1, SW>(P, q0, ring, P.pitch, off, acc0, acc1);
          break;
        default:  // kBox1: the launcher pairs compiled shapes only
          shape_add_pair<kBox1, SW>(P, q0, ring, P.pitch, off, acc0, acc1);
      }
    }
    const int r0 = c * kPairRows;
    __nv_bfloat16* o = out + ((g_step + r0) * P.out_stride[kS] +
                              (base_c0 + x0) * P.out_stride[kC0] +
                              base_c1 + x1);
    const int last = min(t_s, P.out_n[kS] - g_step);
    const bool both = base_c1 + x1 + 1 < P.out_n[kC1];
    if (both && words) {
#pragma unroll
      for (int i = 0; i < kPairRows; ++i)
        if (r0 + i < last)
          *reinterpret_cast<__nv_bfloat162*>(o + i * P.out_stride[kS]) =
              __floats2bfloat162_rn(acc0[i], acc1[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kPairRows; ++i) {
        if (r0 + i >= last) continue;
        __nv_bfloat16* oi = o + i * P.out_stride[kS];
        oi[0] = __float2bfloat16_rn(acc0[i]);
        if (both) oi[1] = __float2bfloat16_rn(acc1[i]);
      }
    }
  }
}

template <typename T, int SW>
__global__ void __launch_bounds__(512, 2)
    sweep_apply_kernel(const __grid_constant__ ApplyParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The roles' grid axes are constants, so every per-axis parameter is
  // read from the parameter bank at a fixed index.
  constexpr int kS = role_axis(SW, 0), kC0 = role_axis(SW, 1),
                kC1 = role_axis(SW, 2);
  const int tc1 = blockIdx.x % P.ntiles_c1;
  const int tc0 = blockIdx.x / P.ntiles_c1;
  const int t_s = P.tile[kS];
  const int t1 = P.tile[kC1];
  const int base_c0 = tc0 * P.tile[kC0];
  const int base_c1 = tc1 * t1;
  const long long first =
      static_cast<long long>(-P.org[kS]) * P.in_stride[kS] +
      static_cast<long long>(base_c0 - P.org[kC0]) * P.in_stride[kC0] +
      static_cast<long long>(base_c1 - P.org[kC1]) * P.in_stride[kC1];
  const int n_items = (t_s + kRows - 1) / kRows * P.tile[kC0] * t1;
  const FastDiv by_plane = make_div(P.tile[kC0] * t1), by_t1 = make_div(t1);
  T* out = static_cast<T*>(P.out);
  // Ring slot of the window row that holds output row g_step (its row
  // g_step + lo_s of the padded sweep axis), kept from step to step.
  int m0 = P.lo[kS] % P.rows;

  for (int k = 0; k < P.nswp; ++k) {
    window_step(k, P.nswp, t_s, P.h_s, P.pipelined,
                [&](long long g0, int n) {
                  for (int a = 0; a < P.p; ++a)
                    load_rows_pitched<kThreads, kS, kC0, kC1>(
                        P, static_cast<const T*>(P.in[a]),
                        ring_of<T>(P, smem, a, first), g0, n, base_c0,
                        base_c1);
                });
    const int g_step = k * t_s;
    if constexpr (sizeof(T) == 2 && SW < 2) {
      if (P.pair) {
        pair_step<SW>(P, smem, first, g_step, base_c0, base_c1, m0);
        m0 += t_s;
        if (m0 >= P.rows) m0 -= P.rows;
        continue;
      }
    }
    for (int u = threadIdx.x; u < n_items; u += kThreads) {
      int rem, x1;
      const int c = divide(u, by_plane, rem);
      const int x0 = divide(rem, by_t1, x1);
      if (base_c0 + x0 >= P.out_n[kC0] || base_c1 + x1 >= P.out_n[kC1])
        continue;  // past the grid: nothing to compute or store
      const int rows = P.rows;
      int m = m0 + c * kRows;
      while (m >= rows) m -= rows;
      const int cross = (x0 + P.lo[kC0]) * P.pitch + x1 + P.lo[kC1];
      int off[kSpan];
      int slot = m - kReach;
      while (slot < 0) slot += rows;
#pragma unroll
      for (int j = 0; j < kSpan; ++j) {
        off[j] = slot * P.plane + cross;
        slot = slot + 1 == rows ? 0 : slot + 1;
      }
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
      for (int a = 0; a < P.p; ++a) {
        const T* ring = ring_of<T>(P, smem, a, first);
        const int q0 = P.tap_begin[a];
        switch (P.shape[a]) {
          case kStar2:
            shape_add<kStar2, SW>(P, q0, ring, P.pitch, off, acc);
            break;
          case kStar1:
            shape_add<kStar1, SW>(P, q0, ring, P.pitch, off, acc);
            break;
          case kBox1:
            shape_add<kBox1, SW>(P, q0, ring, P.pitch, off, acc);
            break;
          default:
            table_add(P, q0, P.tap_begin[a + 1], ring, off, m, cross, acc);
        }
      }
      const int r0 = c * kRows;
      T* o = out + ((g_step + r0) * P.out_stride[kS] +
                    (base_c0 + x0) * P.out_stride[kC0] +
                    (base_c1 + x1) * P.out_stride[kC1]);
      const int last = min(t_s, P.out_n[kS] - g_step);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (r0 + i < last) o[i * P.out_stride[kS]] = from_f32<T>(acc[i]);
    }
    m0 += t_s;
    if (m0 >= P.rows) m0 -= P.rows;
  }
}

using KernelFn = decltype(&sweep_apply_kernel<float, 0>);

// The instantiation for the dtype code and sweep axis, with its dynamic
// shared memory raised to smem_bytes.
KernelFn pick(int dtype, int sweep, int smem_bytes, cudaError_t* err) {
  KernelFn fns[2][3] = {
      {sweep_apply_kernel<float, 0>, sweep_apply_kernel<float, 1>,
       sweep_apply_kernel<float, 2>},
      {sweep_apply_kernel<__nv_bfloat16, 0>,
       sweep_apply_kernel<__nv_bfloat16, 1>,
       sweep_apply_kernel<__nv_bfloat16, 2>}};
  KernelFn fn = fns[dtype == 1 ? 1 : 0][sweep];
  *err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  return fn;
}

// Whether every window row of a launch copies by the flat index (copy16):
// every input row starts at a 16-byte boundary, so every tile's window
// row starts at one alignment, a `head`-byte piece before its first
// 16-byte boundary, and ends with a `tail`-byte piece after its last,
// each of 0, 4 or 8 bytes (one cp.async).  geom and ins as
// sweep_apply_launch takes them.
bool rows_copy16(const long long* geom, const void* const* ins, int* head,
                 int* tail) {
  const int sweep = static_cast<int>(geom[15]);
  const int c0 = sweep == 0 ? 1 : 0, c1 = sweep == 2 ? 1 : 2;
  const long long esize = geom[22] == 1 ? 2 : 4;
  const auto aligned = [](long long bytes) { return bytes % 16 == 0; };
  const auto piece = [](long long bytes) {
    return bytes == 0 || bytes == 4 || bytes == 8;
  };
  *head = static_cast<int>(geom[26 + c1] * esize % 16);
  *tail = static_cast<int>(((geom[12 + c1] * esize - *head) % 16 + 16) % 16);
  bool copy16 = geom[c1] == 1 && aligned(geom[sweep] * esize) &&
                aligned(geom[c0] * esize) && aligned(geom[6 + c1] * esize) &&
                piece(*head) && piece(*tail) &&
                geom[12 + c1] * esize >= *head + *tail;
  for (long long a = 0; a < geom[20]; ++a)
    copy16 = copy16 && aligned(reinterpret_cast<long long>(ins[a]));
  return copy16;
}

// Whether a launch takes the pair loop (P.pair): bf16, sweep axis 0 or 1
// with c1 the minor axis of the inputs and the output, an even tile c1
// extent, every RHS a compiled shape, and each ring's output pairs on
// 4-byte words.  A ring starts at its window's first element modulo 16
// bytes (ring_of), and an output pair's first element sits lo[c1] + x1
// elements into its window row: with the c0 stride even (so the shared
// pitch is) and the tile's c1 extent even, that is a word for every tile
// where it is for the first.  P as sweep_apply_launch fills it.
bool rows_pair(const ApplyParams& P, int dtype, int sweep,
               const void* const* ins) {
  const int c0 = sweep == 0 ? 1 : 0, c1 = 2;
  if (dtype != 1 || sweep == 2 || P.in_stride[c1] != 1 ||
      P.out_stride[c1] != 1 || P.in_stride[c0] % 2 || P.tile[c1] % 2)
    return false;
  // The first tile's window start, in elements from the input's element 0,
  // and the pair's column in it.
  const long long at = -P.org[sweep] * P.in_stride[sweep] -
                       P.org[c0] * P.in_stride[c0] - P.org[c1] + P.lo[c1];
  for (int a = 0; a < P.p; ++a)
    if (P.shape[a] == kShapeTable ||
        (reinterpret_cast<unsigned long long>(ins[a]) +
         static_cast<unsigned long long>(at) * 2) % 4 != 0)
      return false;
  return true;
}

}  // namespace

// geom (int64, 3-D after the wrapper's leading-axis padding):
//   [0:3] in_stride  [3:6] out_stride  [6:9] tile  [9:12] lo  [12:15] win
//   [15] sweep  [16] nswp  [17] ntiles_c0  [18] ntiles_c1  [19] pipelined
//   [20] p  [21] threads  [22] dtype (0 = float32, 1 = bfloat16)
//   [23:26] the inputs' extents  [26:29] the window coordinate of their
//   element 0 (lo where the inputs are the caller's grid, 0 for padded
//   buffers)  [29:32] the output's extents  [32] row_pad: elements a
//   window row's shared row gains, so that a flat copy can take every
//   16-byte block the row touches (the pieces at its ends with their
//   neighbours) instead of copying the pieces apart
// tap_begin: p + 1 prefix counts; tap_off: 3 ints per tap (axis order);
// tap_w: one float per tap.  Shared memory, per RHS (its ring): rows x
// plane elements, plane = w0 x pitch rounded up to 16 bytes, pitch the
// least extent >= w1 + row_pad whose bytes equal the input's c0 stride
// modulo 16 (w1 + row_pad where c1 is not the minor axis), plus 16 bytes
// for the ring's alignment shift (core/tiling.py::apply_smem_bytes).
// smem_bytes must equal that: -1 means it does not (or exceeds 227 KB),
// -2 that the taps or RHS exceed the fixed tables (or an offset does not
// pack), -3 that threads is not kThreads, -kCudaErrorBase - e that the
// launch failed with CUDA error e.  A launch enqueued returns the row path
// it set up, >= 0: kRowsCopy16 where every window row copies by the flat
// index (P.copy16), plus kRowsSpan where those rows also copy the blocks
// around their end pieces (P.span), plus kRowsPair where the bf16 kernel
// computes two neighbouring outputs a thread (P.pair, rows_pair).
extern "C" int sweep_apply_launch(const long long* geom,
                                  const void* const* ins, void* out,
                                  const int* tap_begin, const int* tap_off,
                                  const float* tap_w, int smem_bytes,
                                  void* stream) {
  ApplyParams P{};
  for (int i = 0; i < 3; ++i) {
    P.in_stride[i] = geom[i];
    P.out_stride[i] = geom[3 + i];
    P.tile[i] = static_cast<int>(geom[6 + i]);
    P.lo[i] = static_cast<int>(geom[9 + i]);
    P.win[i] = static_cast<int>(geom[12 + i]);
    P.n[i] = static_cast<int>(geom[23 + i]);
    P.org[i] = static_cast<int>(geom[26 + i]);
    P.out_n[i] = static_cast<int>(geom[29 + i]);
  }
  // The sweep axis and the two cross axes (c0 < c1).
  const int sweep = static_cast<int>(geom[15]);
  const int c0 = sweep == 0 ? 1 : 0, c1 = sweep == 2 ? 1 : 2;
  P.nswp = static_cast<int>(geom[16]);
  const long long ntiles_c0 = geom[17];
  P.ntiles_c1 = static_cast<int>(geom[18]);
  P.pipelined = static_cast<int>(geom[19]);
  P.p = static_cast<int>(geom[20]);
  const int threads = static_cast<int>(geom[21]);
  const int dtype = static_cast<int>(geom[22]);
  if (threads != kThreads) return -3;
  if (P.p < 1 || P.p > kMaxRhs || tap_begin[P.p] > kMaxTaps) return -2;
  const int t_s = P.tile[sweep];
  P.h_s = P.win[sweep] - t_s;
  P.rows = P.win[sweep] + (P.pipelined ? t_s : 0);
  const int esize = dtype == 1 ? 2 : 4;
  const int w0 = P.win[c0], w1 = P.win[c1];
  const int row_pad = static_cast<int>(geom[32]);
  P.pitch = w1 + row_pad;
  if (P.in_stride[c1] == 1)
    while ((P.pitch - P.in_stride[c0]) * esize % 16 != 0) ++P.pitch;
  const int plane_bytes = align16(static_cast<long long>(w0) * P.pitch * esize);
  P.plane = plane_bytes / esize;
  P.ring_bytes = align16(static_cast<long long>(P.rows) * plane_bytes + 16);
  const long long need = static_cast<long long>(P.ring_bytes) * P.p;
  if (need != smem_bytes || need > kSmemLimit) return -1;
  for (int a = 0; a < P.p; ++a) P.in[a] = ins[a];
  P.copy16 = rows_copy16(geom, ins, &P.head, &P.tail);
  P.span = P.copy16 && row_pad * esize == (16 - P.head) % 16 +
                                           (16 - P.tail) % 16 && row_pad > 0;
  // Lanes a row: the power of two (4 to 32) at or above the units of a
  // row with one piece at each end (more pieces take a second turn).
  P.group = 4;
  while (P.group < 32 && P.group < w1 * esize / 16 + 2) P.group *= 2;
  P.out = out;
  for (int a = 0; a <= P.p; ++a) P.tap_begin[a] = tap_begin[a];
  for (int q = 0; q < tap_begin[P.p]; ++q) {
    const int* o = tap_off + 3 * q;
    const int oc = o[c0] * P.pitch + o[c1];
    if (oc < -(1 << 23) || oc >= (1 << 23) || o[sweep] < -128 ||
        o[sweep] > 127)
      return -2;
    int wbits;
    memcpy(&wbits, tap_w + q, sizeof(wbits));
    P.tap[q] = make_int2(
        static_cast<int>(static_cast<unsigned>(o[sweep]) << 24 |
                         (static_cast<unsigned>(oc) & 0xFFFFFFu)),
        wbits);
  }
  for (int a = 0; a < P.p; ++a) {
    P.shape[a] = kShapeTable;
    const int n = tap_begin[a + 1] - tap_begin[a];
    for (int sh : {kStar1, kStar2, kBox1}) {
      bool same = n == shape_taps(sh);
      for (int t = 0; same && t < n; ++t)
        for (int ax = 0; ax < 3; ++ax)
          same = same &&
                 tap_off[3 * (tap_begin[a] + t) + ax] ==
                     shape_axis_off(sh, t, ax);
      if (same) P.shape[a] = sh;
    }
  }
  P.pair = rows_pair(P, dtype, sweep, ins);
  cudaError_t err;
  KernelFn fn = pick(dtype, sweep, smem_bytes, &err);
  if (err == cudaSuccess) {
    const dim3 grid(static_cast<unsigned>(ntiles_c0 * P.ntiles_c1));
    void* args[] = {&P};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid,
                           dim3(kThreads), args, smem_bytes,
                           static_cast<cudaStream_t>(stream));
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return -kCudaErrorBase - static_cast<int>(err);
  return (P.copy16 ? kRowsCopy16 : 0) | (P.span ? kRowsSpan : 0) |
         (P.pair ? kRowsPair : 0);
}

// 1 where sweep_apply_launch, handed the same geom and ins, copies every
// window row by the flat index of 16-byte blocks and end pieces (copy16),
// else 0.  Launches nothing.
extern "C" int sweep_apply_copy16(const long long* geom,
                                  const void* const* ins) {
  int head, tail;
  return rows_copy16(geom, ins, &head, &tail) ? 1 : 0;
}

// CTAs of the (dtype, sweep axis) instantiation resident on one SM at
// `smem_bytes` of dynamic shared memory and kThreads threads, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative value is the
// negated CUDA error (or -1 for a sweep axis outside 0..2).
extern "C" int sweep_apply_occupancy(int dtype, int sweep, int smem_bytes) {
  if (sweep < 0 || sweep > 2) return -1;
  cudaError_t err;
  KernelFn fn = pick(dtype, sweep, smem_bytes, &err);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                        smem_bytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
