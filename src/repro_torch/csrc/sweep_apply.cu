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
// bandwidth (67 TFLOP/s over 3.35 TB/s).  The least time is the padded
// inputs read once plus the output written once at 3.35 TB/s.
//
// What the design does about it: every input element crosses HBM about
// once per sweep column.  One CTA owns one cross-axis tile column and loops
// over its nswp sweep steps itself (a CUDA grid has no order and no
// persistent scratch, unlike the TPU grid); the sweep-axis overlap of
// consecutive windows stays in a shared-memory ring indexed modulo its
// depth, so a step fetches only its new t_s rows.  With `pipelined`, the
// ring has t_s spare rows and the next slab arrives by cp.async while the
// current step computes (4-byte element types; cp.async has no 2-byte
// granule, so bf16 slabs are copied synchronously into the same slots).
// Threads map to the minor axis, so loads and stores coalesce when the
// sweep axis is not the minor one.  Only the cross-axis halo is re-read,
// by neighbouring columns.
//
// Bit-exactness: taps are applied in zip(offsets, weights) order as
// separate f32 multiplies and adds (built with --fmad=false), so the result
// equals the plain PyTorch version in kernels/sweep.py bit for bit.

#include "sweep_common.cuh"

namespace {

constexpr int kMaxRhs = 8;
constexpr int kMaxTaps = 192;

struct ApplyParams {
  const void* in[kMaxRhs];
  void* out;
  long long in_stride[3];   // element strides of the padded inputs
  long long out_stride[3];  // element strides of the padded output
  int tile[3];
  int lo[3];   // window halo below the tile, per axis
  int win[3];  // window extent tile + lo + hi, per axis
  int sweep, c0, c1;  // the sweep axis and the two cross axes (c0 < c1)
  int nswp;           // sweep steps per column
  int ntiles_c1;      // tile columns along c1 (decodes blockIdx.x)
  int rows;           // ring depth in sweep rows
  int h_s;            // sweep-axis window halo lo + hi
  int pipelined;
  int p;
  int ring_bytes;     // bytes between consecutive RHS rings (16-aligned)
  int tap_begin[kMaxRhs + 1];
  int tap_s[kMaxTaps];  // tap offset along the sweep axis
  int tap_c[kMaxTaps];  // tap offset within a window plane (c0, c1)
  float tap_w[kMaxTaps];
};

template <typename T>
__global__ void __launch_bounds__(256)
    sweep_apply_kernel(const __grid_constant__ ApplyParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc1 = blockIdx.x % P.ntiles_c1;
  const int tc0 = blockIdx.x / P.ntiles_c1;
  const long long base_c0 = static_cast<long long>(tc0) * P.tile[P.c0];
  const long long base_c1 = static_cast<long long>(tc1) * P.tile[P.c1];
  const int t_s = P.tile[P.sweep];
  const int t0 = P.tile[P.c0];
  const int t1 = P.tile[P.c1];
  const int w1 = P.win[P.c1];
  const int plane = P.win[P.c0] * w1;
  const int n_out = t_s * t0 * t1;
  const int lo_s = P.lo[P.sweep];
  T* out = static_cast<T*>(P.out);

  for (int k = 0; k < P.nswp; ++k) {
    window_step(k, P.nswp, t_s, P.h_s, P.pipelined,
                [&](long long g0, int n) {
                  for (int a = 0; a < P.p; ++a)
                    load_rows(P, static_cast<const T*>(P.in[a]),
                              reinterpret_cast<T*>(smem + a * P.ring_bytes),
                              g0, n, base_c0, base_c1);
                });
    const long long g_step = static_cast<long long>(k) * t_s;
    for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
      const int x1 = e % t1;
      const int t = e / t1;
      const int x0 = t % t0;
      const int r = t / t0;
      const int cross = (x0 + P.lo[P.c0]) * w1 + (x1 + P.lo[P.c1]);
      // Ring slot of window row r + lo_s; each tap shifts it by tap_s.
      const int m = static_cast<int>((g_step + r + lo_s) % P.rows);
      float acc = 0.0f;
      for (int a = 0; a < P.p; ++a) {
        const T* ring = reinterpret_cast<const T*>(smem + a * P.ring_bytes);
        for (int q = P.tap_begin[a]; q < P.tap_begin[a + 1]; ++q) {
          int slot = m + P.tap_s[q];
          if (slot < 0) slot += P.rows;
          else if (slot >= P.rows) slot -= P.rows;
          const float x = to_f32(ring[slot * plane + cross + P.tap_c[q]]);
          acc = __fadd_rn(acc, __fmul_rn(P.tap_w[q], x));
        }
      }
      out[(g_step + r) * P.out_stride[P.sweep] +
          (base_c0 + x0) * P.out_stride[P.c0] +
          (base_c1 + x1) * P.out_stride[P.c1]] = from_f32<T>(acc);
    }
  }
}

}  // namespace

// geom (int64, 3-D after the wrapper's leading-axis padding):
//   [0:3] in_stride  [3:6] out_stride  [6:9] tile  [9:12] lo  [12:15] win
//   [15] sweep  [16] nswp  [17] ntiles_c0  [18] ntiles_c1  [19] pipelined
//   [20] p  [21] threads  [22] dtype (0 = float32, 1 = bfloat16)
// tap_begin: p + 1 prefix counts; tap_off: 3 ints per tap (axis order);
// tap_w: one float per tap.  smem_bytes must equal the layout computed
// here (repro_torch.core.tiling.sweep_smem_bytes); -1 means it does not,
// -2 that the taps or RHS exceed the fixed tables.  Otherwise the return
// is cudaGetLastError() after the launch.
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
  }
  P.sweep = static_cast<int>(geom[15]);
  P.c0 = P.sweep == 0 ? 1 : 0;
  P.c1 = P.sweep == 2 ? 1 : 2;
  P.nswp = static_cast<int>(geom[16]);
  const long long ntiles_c0 = geom[17];
  P.ntiles_c1 = static_cast<int>(geom[18]);
  P.pipelined = static_cast<int>(geom[19]);
  P.p = static_cast<int>(geom[20]);
  const int threads = static_cast<int>(geom[21]);
  const int dtype = static_cast<int>(geom[22]);
  if (P.p < 1 || P.p > kMaxRhs || tap_begin[P.p] > kMaxTaps) return -2;
  const int t_s = P.tile[P.sweep];
  P.h_s = P.win[P.sweep] - t_s;
  P.rows = P.win[P.sweep] + (P.pipelined ? t_s : 0);
  const int esize = dtype == 1 ? 2 : 4;
  P.ring_bytes = align16(static_cast<long long>(P.rows) * P.win[P.c0] *
                         P.win[P.c1] * esize);
  const long long need = static_cast<long long>(P.ring_bytes) * P.p;
  if (need != smem_bytes || need > kSmemLimit) return -1;
  for (int a = 0; a < P.p; ++a) P.in[a] = ins[a];
  P.out = out;
  for (int a = 0; a <= P.p; ++a) P.tap_begin[a] = tap_begin[a];
  for (int q = 0; q < tap_begin[P.p]; ++q) {
    const int* o = tap_off + 3 * q;
    P.tap_s[q] = o[P.sweep];
    P.tap_c[q] = o[P.c0] * P.win[P.c1] + o[P.c1];
    P.tap_w[q] = tap_w[q];
  }
  const dim3 grid(static_cast<unsigned>(ntiles_c0 * P.ntiles_c1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(sweep_apply_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sweep_apply_kernel<__nv_bfloat16><<<grid, threads, smem_bytes, s>>>(P);
  } else {
    err = cudaFuncSetAttribute(sweep_apply_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sweep_apply_kernel<float><<<grid, threads, smem_bytes, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}
