// sweep_chain: a fused T-stage stencil chain (T >= 2, one RHS) in one pass
// over device memory, swept along one axis with per-stage frontiers kept in
// shared memory.
//
// Replaces: src/repro/kernels/stencil.py::_sweep_kernel (line 148), parts
//   B1 (window pipeline), B3 (`full_compute`, the warm-up of each sweep
//   column over every stage's full suffix-halo extent, intermediates masked
//   to the true domain) and B4 (`streaming_step`: each later step computes
//   only the t_s newly uncovered rows of each stage from ring or trapezoid
//   frontiers).
//
// What bounds it on an H100: bytes.  T applications of a 13-point star do
// 26·T flops per output point against 8 bytes of f32 traffic; even at T = 3
// that is ~10 flops per byte, below the card's ~20 f32 flops per byte of
// HBM bandwidth.  The least time is the padded input read once plus the
// output written once at 3.35 TB/s; the fused chain makes that T times less
// traffic than T separate applications.
//
// What the design does about it: the T-1 intermediate iterates never leave
// shared memory.  One CTA owns one cross-axis tile column and loops over
// its sweep steps (a CUDA grid has no order and no persistent scratch).
// The input window is a ring indexed modulo its depth (plus t_s landing
// rows filled by cp.async while the step computes, when `pipelined`), and
// frontier j is a ring of stage j's output rows indexed by global row
// modulo its depth: t_s + lo_{j+1} + hi_{j+1} rows under "ring", the full
// suffix extent under "trapezoid".  The host hands the kernel a schedule of
// (stage, first row, end row) entries: at k = 0 the warm-up (one entry per
// stage over its whole extent for "trapezoid"; under "ring", chunks
// interleaved across stages so no ring is overrun), at k > 0 one entry per
// stage for its t_s new rows.  Every element is computed by the same
// expression whatever the schedule, so ring and trapezoid agree bit for
// bit.  Frontiers hold f32 values already rounded through the stage dtype
// (the input's in this slice), exactly what the reference stores.
//
// Bit-exactness: taps are applied in zip(offsets, weights) order as
// separate f32 multiplies and adds (built with --fmad=false), and
// intermediates are zeroed outside [0, n_true) in global coordinates
// (`dom` lifts the local origin; all zeros on one card), so the result
// equals the plain stage-by-stage version in kernels/sweep.py bit for bit.

#include "sweep_common.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kMaxTaps = 160;
constexpr int kMaxSched = 96;

struct ChainParams {
  const void* in;
  void* out;
  long long in_stride[3];
  long long out_stride[3];
  int tile[3];
  int lo_w[3];  // window (chain cone) halo below the tile
  int win[3];   // window extent tile + lo_w + hi_w
  int n_true[3];
  int dom[3];   // global coordinate of local element 0
  int sweep, c0, c1;
  int nswp, ntiles_c1, rows, h_s, pipelined, T;
  int n_warm, n_steady;
  int st_lo[kMaxStages][3];      // stage's own halo below
  int st_sfx_lo[kMaxStages][3];  // later stages' summed halo below
  int st_ext[kMaxStages][3];     // stage's computed extent per axis
  int depth[kMaxStages];         // frontier ring depth (stages < T-1)
  int foff[kMaxStages];          // frontier byte offset in shared memory
  int tap_begin[kMaxStages + 1];
  int tap_s[kMaxTaps];
  int tap_c[kMaxTaps];  // offset within the source plane (c0, c1)
  float tap_w[kMaxTaps];
  int sched[kMaxSched][3];  // (stage, r0, r1), rows relative to k * t_s
};

// f32 sum of stage j's taps at one output element; `m` is the ring slot
// of the element's own row in the source ring, `cross` its offset within a
// source plane.
template <typename S>
__device__ __forceinline__ float stage_acc(const ChainParams& P, int j,
                                           const S* src, int depth,
                                           int plane, int m, int cross) {
  float acc = 0.0f;
  for (int q = P.tap_begin[j]; q < P.tap_begin[j + 1]; ++q) {
    int slot = m + P.tap_s[q];
    if (slot < 0) slot += depth;
    else if (slot >= depth) slot -= depth;
    const float x = to_f32(src[slot * plane + cross + P.tap_c[q]]);
    acc = __fadd_rn(acc, __fmul_rn(P.tap_w[q], x));
  }
  return acc;
}

// Stage j over rows [r0, r1) (relative to the step's first output row
// g_step) and its whole cross extent.
template <typename T>
__device__ void run_entry(const ChainParams& P, unsigned char* smem, int j,
                          int r0, int r1, long long g_step, long long base_c0,
                          long long base_c1) {
  const int s = P.sweep, c0 = P.c0, c1 = P.c1;
  const int e0 = P.st_ext[j][c0];
  const int e1 = P.st_ext[j][c1];
  const int n = (r1 - r0) * e0 * e1;
  int src_w0, src_w1, src_depth, src_origin;
  if (j == 0) {
    src_w0 = P.win[c0];
    src_w1 = P.win[c1];
    src_depth = P.rows;
    src_origin = P.lo_w[s];
  } else {
    src_w0 = P.st_ext[j - 1][c0];
    src_w1 = P.st_ext[j - 1][c1];
    src_depth = P.depth[j - 1];
    src_origin = P.st_sfx_lo[j - 1][s];
  }
  const int src_plane = src_w0 * src_w1;
  const bool last = j == P.T - 1;
  T* out = static_cast<T*>(P.out);
  float* front = last ? nullptr : reinterpret_cast<float*>(smem + P.foff[j]);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int x1 = e % e1;
    const int t = e / e1;
    const int x0 = t % e0;
    const long long g = g_step + r0 + t / e0;  // global sweep row
    const int cross = (x0 + P.st_lo[j][c0]) * src_w1 + (x1 + P.st_lo[j][c1]);
    const int m = static_cast<int>((g + src_origin) % src_depth);
    const float acc =
        j == 0 ? stage_acc(P, j, reinterpret_cast<const T*>(smem), src_depth,
                           src_plane, m, cross)
               : stage_acc(P, j,
                           reinterpret_cast<const float*>(smem + P.foff[j - 1]),
                           src_depth, src_plane, m, cross);
    if (last) {
      out[g * P.out_stride[s] + (base_c0 + x0) * P.out_stride[c0] +
          (base_c1 + x1) * P.out_stride[c1]] = from_f32<T>(acc);
    } else {
      const long long gs = P.dom[s] + g;
      const long long g0 = P.dom[c0] + base_c0 - P.st_sfx_lo[j][c0] + x0;
      const long long g1 = P.dom[c1] + base_c1 - P.st_sfx_lo[j][c1] + x1;
      const bool inside = gs >= 0 && gs < P.n_true[s] && g0 >= 0 &&
                          g0 < P.n_true[c0] && g1 >= 0 && g1 < P.n_true[c1];
      const float v = inside ? to_f32(from_f32<T>(acc)) : 0.0f;
      const int fslot = static_cast<int>((g + P.st_sfx_lo[j][s]) % P.depth[j]);
      front[(fslot * e0 + x0) * e1 + x1] = v;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(256)
    sweep_chain_kernel(const __grid_constant__ ChainParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc1 = blockIdx.x % P.ntiles_c1;
  const int tc0 = blockIdx.x / P.ntiles_c1;
  const long long base_c0 = static_cast<long long>(tc0) * P.tile[P.c0];
  const long long base_c1 = static_cast<long long>(tc1) * P.tile[P.c1];
  const int t_s = P.tile[P.sweep];
  const T* in = static_cast<const T*>(P.in);
  T* ring = reinterpret_cast<T*>(smem);

  for (int k = 0; k < P.nswp; ++k) {
    window_step(k, P.nswp, t_s, P.h_s, P.pipelined,
                [&](long long g0, int n) {
                  load_rows(P, in, ring, g0, n, base_c0, base_c1);
                });
    const long long g_step = static_cast<long long>(k) * t_s;
    const int first = k == 0 ? 0 : P.n_warm;
    const int end = k == 0 ? P.n_warm : P.n_warm + P.n_steady;
    for (int i = first; i < end; ++i)
      run_entry<T>(P, smem, P.sched[i][0], P.sched[i][1], P.sched[i][2],
                   g_step, base_c0, base_c1);
  }
}

}  // namespace

// geom (int64, 3-D after the wrapper's leading-axis padding):
//   [0:3] in_stride  [3:6] out_stride  [6:9] tile  [9:12] lo_w  [12:15] win
//   [15] sweep  [16] nswp  [17] ntiles_c0  [18] ntiles_c1  [19] pipelined
//   [20] T  [21] threads  [22] dtype (0 = float32, 1 = bfloat16)
//   [23:26] n_true  [26:29] dom
// stage_geom: 10 ints per stage: lo[3], sfx_lo[3], ext[3], frontier depth.
// tap_begin: T + 1 prefix counts; tap_off: 3 ints per tap (axis order);
// tap_w: one float per tap; sched: 3 ints per entry, n_warm warm-up entries
// then n_steady steady ones.  smem_bytes must equal the layout computed
// here (repro_torch.core.tiling.sweep_smem_bytes); -1 means it does not,
// -2 that stages, taps or schedule exceed the fixed tables.  Otherwise the
// return is cudaGetLastError() after the launch.
extern "C" int sweep_chain_launch(const long long* geom, const int* stage_geom,
                                  const int* tap_begin, const int* tap_off,
                                  const float* tap_w, const int* sched,
                                  int n_warm, int n_steady, const void* in,
                                  void* out, int smem_bytes, void* stream) {
  ChainParams P{};
  for (int i = 0; i < 3; ++i) {
    P.in_stride[i] = geom[i];
    P.out_stride[i] = geom[3 + i];
    P.tile[i] = static_cast<int>(geom[6 + i]);
    P.lo_w[i] = static_cast<int>(geom[9 + i]);
    P.win[i] = static_cast<int>(geom[12 + i]);
    P.n_true[i] = static_cast<int>(geom[23 + i]);
    P.dom[i] = static_cast<int>(geom[26 + i]);
  }
  P.sweep = static_cast<int>(geom[15]);
  P.c0 = P.sweep == 0 ? 1 : 0;
  P.c1 = P.sweep == 2 ? 1 : 2;
  P.nswp = static_cast<int>(geom[16]);
  const long long ntiles_c0 = geom[17];
  P.ntiles_c1 = static_cast<int>(geom[18]);
  P.pipelined = static_cast<int>(geom[19]);
  P.T = static_cast<int>(geom[20]);
  const int threads = static_cast<int>(geom[21]);
  const int dtype = static_cast<int>(geom[22]);
  if (P.T < 2 || P.T > kMaxStages || tap_begin[P.T] > kMaxTaps ||
      n_warm + n_steady > kMaxSched)
    return -2;
  P.n_warm = n_warm;
  P.n_steady = n_steady;
  const int t_s = P.tile[P.sweep];
  P.h_s = P.win[P.sweep] - t_s;
  P.rows = P.win[P.sweep] + (P.pipelined ? t_s : 0);
  const int esize = dtype == 1 ? 2 : 4;
  long long need = align16(static_cast<long long>(P.rows) * P.win[P.c0] *
                           P.win[P.c1] * esize);
  for (int j = 0; j < P.T; ++j) {
    const int* sg = stage_geom + 10 * j;
    for (int i = 0; i < 3; ++i) {
      P.st_lo[j][i] = sg[i];
      P.st_sfx_lo[j][i] = sg[3 + i];
      P.st_ext[j][i] = sg[6 + i];
    }
    P.depth[j] = sg[9];
    if (j < P.T - 1) {
      P.foff[j] = static_cast<int>(need);
      need += align16(static_cast<long long>(P.depth[j]) *
                      P.st_ext[j][P.c0] * P.st_ext[j][P.c1] * 4);
    }
  }
  if (need != smem_bytes || need > kSmemLimit) return -1;
  P.in = in;
  P.out = out;
  for (int j = 0; j <= P.T; ++j) P.tap_begin[j] = tap_begin[j];
  for (int j = 0; j < P.T; ++j) {
    // A stage reads the window (j == 0) or the previous frontier.
    const int src_w1 = j == 0 ? P.win[P.c1] : P.st_ext[j - 1][P.c1];
    for (int q = tap_begin[j]; q < tap_begin[j + 1]; ++q) {
      const int* o = tap_off + 3 * q;
      P.tap_s[q] = o[P.sweep];
      P.tap_c[q] = o[P.c0] * src_w1 + o[P.c1];
      P.tap_w[q] = tap_w[q];
    }
  }
  for (int i = 0; i < n_warm + n_steady; ++i)
    for (int c = 0; c < 3; ++c) P.sched[i][c] = sched[3 * i + c];
  const dim3 grid(static_cast<unsigned>(ntiles_c0 * P.ntiles_c1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(sweep_chain_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sweep_chain_kernel<__nv_bfloat16><<<grid, threads, smem_bytes, s>>>(P);
  } else {
    err = cudaFuncSetAttribute(sweep_chain_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sweep_chain_kernel<float><<<grid, threads, smem_bytes, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}
