// sweep_chain: a chain of T >= 1 stencil stages (one RHS) in one pass over
// device memory, swept along one axis with per-stage frontiers kept in
// shared memory, with boundary conditions, per-stage storage dtypes and
// int8-quantized frontiers.
//
// Replaces: src/repro/kernels/stencil.py::_sweep_kernel (line 148), parts
//   B1 (window pipeline), B3 (`full_compute`, the warm-up of each sweep
//   column over every stage's full suffix-halo extent, intermediates masked
//   to the true domain), B4 (`streaming_step`: each later step computes
//   only the t_s newly uncovered rows of each stage from ring or trapezoid
//   frontiers), B5 (`bc_terms`: dirichlet, neumann, reflect and robin
//   correction taps; periodic through the host's wrap fill and widened
//   masks), the per-stage storage dtypes, and B6 (`quantize_store` and the
//   `q_src`/`in_quant` dequantize of `stage_apply`).
//
// What bounds it on an H100: bytes.  T applications of a 13-point star do
// 26·T flops per output point against 8 bytes of f32 traffic; even at T = 3
// that is ~10 flops per byte, below the card's ~20 f32 flops per byte of
// HBM bandwidth.  The least time is the input read once plus the output
// written once at 3.35 TB/s; the fused chain makes that T times less
// traffic than T separate applications.  Boundary corrections add work only
// at the domain's faces and no bytes: the bound does not count them.
//
// What the design does about it: the T-1 intermediate iterates never leave
// shared memory.  One CTA owns one cross-axis tile column and loops over
// its sweep steps (a CUDA grid has no order and no persistent scratch).
// The input window is a ring indexed modulo its depth (plus t_s landing
// rows filled by cp.async while the step computes, when `pipelined`; bf16
// and int8 rows are copied synchronously), and frontier j is a ring of
// stage j's output rows indexed by global row modulo its depth: t_s +
// lo_{j+1} + hi_{j+1} rows under "ring", the full suffix extent under
// "trapezoid".  The host hands the kernel a schedule of (stage, first row,
// end row) entries: at k = 0 the warm-up (one entry per stage over its
// whole extent for "trapezoid"; under "ring", chunks interleaved across
// stages so no ring is overrun), at k > 0 one entry per stage for its t_s
// new rows.  Every element is computed by the same expression whatever the
// schedule, so ring and trapezoid agree bit for bit.
//
// Boundary conditions: the host enumerates every correction term of every
// stage in the reference's order (per tap: the dirichlet/robin constant,
// then each combination of per-axis exit depths) into a table in device
// memory, 12 ints a row: a constant fires where the tap's read leaves the
// domain, a read fires where the element lies on the term's global planes
// and reads the clamped (neumann, robin) or mirrored (reflect) cell.  The
// terms add up in their own f32 sum from zero, which joins the tap sum
// once, as the reference's `acc + bc_terms(...)` does.  Elements farther
// than the stage's halo from every face skip the table.  Periodic needs no
// terms: the host wraps the ghost cells and the masks keep each stage's
// suffix margin [-suffix_lo, n + suffix_hi).
//
// Storage dtypes: frontiers stay f32 in shared memory whatever the stage
// dtype, holding the value already rounded as the reference stores it: a
// bf16 round trip, or for a quantized stage the code
// clip(rint(x / s) + zp, -128, 127) read back as (q - zp)·s, computed once
// at the store.  The domain mask zeroes the sum before it is rounded, so a
// masked element stores code zp and reads back as exact 0.  Holding
// frontiers at their own width would save shared memory; that is a speed
// change for later.  The output takes the last stage's type (int8 codes
// when it is quantized); an int8 input (a quantized hand-off) is read as
// codes and dequantized with `in_quant` in every read of the window.
//
// Bit-exactness: taps are applied in zip(offsets, weights) order as
// separate f32 multiplies and adds (built with --fmad=false), quantizing
// uses the IEEE divide and rintf (half to even), and intermediates are
// masked in global coordinates (`dom` lifts the local origin; all zeros on
// one card), so the result equals the plain stage-by-stage version in
// kernels/sweep.py bit for bit.

#include "sweep_common.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kMaxTaps = 160;
constexpr int kMaxSched = 96;
constexpr int kMaxBc = 4096;
// How a stage's stored value is rounded (stage_geom's rounding code).
constexpr int kRoundBf16 = 1;
constexpr int kRoundQuant = 2;

struct ChainParams {
  const void* in;
  void* out;
  const int4* bc;  // correction terms, 3 int4 (12 ints) per row
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
  int periodic;  // masks keep each stage's suffix margin
  int in_quant;  // the input holds int8 codes of (in_scale, in_zp)
  float in_scale, in_zp;
  int st_lo[kMaxStages][3];      // stage's own halo below
  int st_hi[kMaxStages][3];      // stage's own halo above
  int st_sfx_lo[kMaxStages][3];  // later stages' summed halo below
  int st_ext[kMaxStages][3];     // stage's computed extent per axis
  int depth[kMaxStages];         // frontier ring depth (stages < T-1)
  int foff[kMaxStages];          // frontier byte offset in shared memory
  int round[kMaxStages];         // 0 f32, 1 bf16, 2 quantized
  int has_bc[kMaxStages];        // a non-periodic boundary condition
  float q_scale[kMaxStages];
  float q_zp[kMaxStages];
  int tap_begin[kMaxStages + 1];
  int bc_begin[kMaxStages + 1];
  int tap_s[kMaxTaps];
  int tap_c[kMaxTaps];  // offset within the source plane (c0, c1)
  float tap_w[kMaxTaps];
  short sched[kMaxSched][3];  // (stage, r0, r1), rows relative to k * t_s
};
// The classic kernel-parameter limit; the correction terms live in device
// memory so that the struct stays below it.
static_assert(sizeof(ChainParams) <= 4096, "ChainParams exceeds 4 KB");

__device__ __forceinline__ float quantize_code(float v, float scale,
                                               float zp) {
  return fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(v, scale)), zp), -128.0f),
               127.0f);
}

__device__ __forceinline__ float dequantize(float q, float scale, float zp) {
  return __fmul_rn(__fsub_rn(q, zp), scale);
}

// A source element as the stage's f32 MACs read it: int8 codes of the
// quantized input are dequantized (`dq`).
template <typename S>
__device__ __forceinline__ float src_at(const ChainParams& P, const S* src,
                                        int idx, bool dq) {
  const float x = to_f32(src[idx]);
  return dq ? dequantize(x, P.in_scale, P.in_zp) : x;
}

__device__ __forceinline__ int ring_slot(int slot, int depth) {
  if (slot < 0) return slot + depth;
  if (slot >= depth) return slot - depth;
  return slot;
}

// f32 sum of stage j's taps at one output element; `m` is the ring slot
// of the element's own row in the source ring, `cross` its offset within a
// source plane.
template <typename S>
__device__ __forceinline__ float stage_acc(const ChainParams& P, int j,
                                           const S* src, bool dq, int depth,
                                           int plane, int m, int cross) {
  float acc = 0.0f;
  for (int q = P.tap_begin[j]; q < P.tap_begin[j + 1]; ++q) {
    const int slot = ring_slot(m + P.tap_s[q], depth);
    const float x = src_at(P, src, slot * plane + cross + P.tap_c[q], dq);
    acc = __fadd_rn(acc, __fmul_rn(P.tap_w[q], x));
  }
  return acc;
}

// f32 sum of stage j's boundary correction terms at one output element
// whose global coordinates are (p0, p1, p2) along (sweep, c0, c1).
template <typename S>
__device__ float bc_sum(const ChainParams& P, int j, const S* src, bool dq,
                        int depth, int plane, int m, int cross, long long p0,
                        long long p1, long long p2) {
  const int s = P.sweep, c0 = P.c0, c1 = P.c1;
  const long long n0 = P.n_true[s], n1 = P.n_true[c0], n2 = P.n_true[c1];
  float add = 0.0f;
  // A term fires only within the stage's own halo of a face.
  if (p0 >= P.st_lo[j][s] && p0 < n0 - P.st_hi[j][s] &&
      p1 >= P.st_lo[j][c0] && p1 < n1 - P.st_hi[j][c0] &&
      p2 >= P.st_lo[j][c1] && p2 < n2 - P.st_hi[j][c1])
    return add;
  auto coord = [&](int r) { return r == 0 ? p0 : (r == 1 ? p1 : p2); };
  auto exits = [&](int r, int off) {
    const long long v = coord(r) + off;
    return v < 0 || v >= (r == 0 ? n0 : (r == 1 ? n1 : n2));
  };
  auto on = [&](int r, int plane_) { return coord(r) == plane_; };
  for (int q = P.bc_begin[j]; q < P.bc_begin[j + 1]; ++q) {
    const int4 a = __ldg(P.bc + 3 * q);      // kind, n, role_0, val_0
    const int4 b = __ldg(P.bc + 3 * q + 1);  // role_1, val_1, role_2, val_2
    const int4 c = __ldg(P.bc + 3 * q + 2);  // o_s, o_c, coef bits, stage
    const bool hit =
        a.x == 0
            ? exits(a.z, a.w) || (a.y > 1 && exits(b.x, b.y)) ||
                  (a.y > 2 && exits(b.z, b.w))
            : on(a.z, a.w) && (a.y < 2 || on(b.x, b.y)) &&
                  (a.y < 3 || on(b.z, b.w));
    if (!hit) continue;
    const float coef = __int_as_float(c.z);
    if (a.x == 0) {
      add = __fadd_rn(add, coef);
    } else {
      const int slot = ring_slot(m + c.x, depth);
      add = __fadd_rn(
          add, __fmul_rn(coef, src_at(P, src, slot * plane + cross + c.y, dq)));
    }
  }
  return add;
}

// Taps plus boundary corrections of stage j at one element.
template <typename S>
__device__ __forceinline__ float stage_value(const ChainParams& P, int j,
                                             const S* src, bool dq, int depth,
                                             int plane, int m, int cross,
                                             long long p0, long long p1,
                                             long long p2) {
  float acc = stage_acc(P, j, src, dq, depth, plane, m, cross);
  if (P.has_bc[j])
    acc = __fadd_rn(
        acc, bc_sum(P, j, src, dq, depth, plane, m, cross, p0, p1, p2));
  return acc;
}

__device__ __forceinline__ bool in_mask(const ChainParams& P, int j, int i,
                                        long long p) {
  long long lo = 0, hi = P.n_true[i];
  if (P.periodic) {
    lo = -P.st_sfx_lo[j][i];
    hi += P.st_ext[j][i] - P.tile[i] - P.st_sfx_lo[j][i];
  }
  return p >= lo && p < hi;
}

// Stage j over rows [r0, r1) (relative to the step's first output row
// g_step) and its whole cross extent.
template <typename Tin, typename Tout>
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
  const bool dq = j == 0 && P.in_quant;
  Tout* out = static_cast<Tout*>(P.out);
  float* front = last ? nullptr : reinterpret_cast<float*>(smem + P.foff[j]);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int x1 = e % e1;
    const int t = e / e1;
    const int x0 = t % e0;
    const long long g = g_step + r0 + t / e0;  // global sweep row
    const int cross = (x0 + P.st_lo[j][c0]) * src_w1 + (x1 + P.st_lo[j][c1]);
    const int m = static_cast<int>((g + src_origin) % src_depth);
    const long long gs = P.dom[s] + g;
    const long long g0 = P.dom[c0] + base_c0 - P.st_sfx_lo[j][c0] + x0;
    const long long g1 = P.dom[c1] + base_c1 - P.st_sfx_lo[j][c1] + x1;
    float acc =
        j == 0 ? stage_value(P, j, reinterpret_cast<const Tin*>(smem), dq,
                             src_depth, src_plane, m, cross, gs, g0, g1)
               : stage_value(
                     P, j, reinterpret_cast<const float*>(smem + P.foff[j - 1]),
                     false, src_depth, src_plane, m, cross, gs, g0, g1);
    if (last) {
      if (P.round[j] == kRoundQuant)
        acc = quantize_code(acc, P.q_scale[j], P.q_zp[j]);
      out[g * P.out_stride[s] + (base_c0 + x0) * P.out_stride[c0] +
          (base_c1 + x1) * P.out_stride[c1]] = from_f32<Tout>(acc);
    } else {
      const bool inside =
          in_mask(P, j, s, gs) && in_mask(P, j, c0, g0) && in_mask(P, j, c1, g1);
      float v = inside ? acc : 0.0f;
      if (P.round[j] == kRoundBf16) {
        v = __bfloat162float(__float2bfloat16_rn(v));
      } else if (P.round[j] == kRoundQuant) {
        v = dequantize(quantize_code(v, P.q_scale[j], P.q_zp[j]),
                       P.q_scale[j], P.q_zp[j]);
      }
      const int fslot = static_cast<int>((g + P.st_sfx_lo[j][s]) % P.depth[j]);
      front[(fslot * e0 + x0) * e1 + x1] = v;
    }
  }
  __syncthreads();
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(256)
    sweep_chain_kernel(const __grid_constant__ ChainParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc1 = blockIdx.x % P.ntiles_c1;
  const int tc0 = blockIdx.x / P.ntiles_c1;
  const long long base_c0 = static_cast<long long>(tc0) * P.tile[P.c0];
  const long long base_c1 = static_cast<long long>(tc1) * P.tile[P.c1];
  const int t_s = P.tile[P.sweep];
  const Tin* in = static_cast<const Tin*>(P.in);
  Tin* ring = reinterpret_cast<Tin*>(smem);

  for (int k = 0; k < P.nswp; ++k) {
    window_step(k, P.nswp, t_s, P.h_s, P.pipelined,
                [&](long long g0, int n) {
                  load_rows(P, in, ring, g0, n, base_c0, base_c1);
                });
    const long long g_step = static_cast<long long>(k) * t_s;
    const int first = k == 0 ? 0 : P.n_warm;
    const int end = k == 0 ? P.n_warm : P.n_warm + P.n_steady;
    for (int i = first; i < end; ++i)
      run_entry<Tin, Tout>(P, smem, P.sched[i][0], P.sched[i][1],
                           P.sched[i][2], g_step, base_c0, base_c1);
  }
}

template <typename Tin, typename Tout>
int launch(const ChainParams& P, dim3 grid, int threads, int smem_bytes,
           cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      sweep_chain_kernel<Tin, Tout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_chain_kernel<Tin, Tout><<<grid, threads, smem_bytes, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int launch_out(int out_dtype, const ChainParams& P, dim3 grid, int threads,
               int smem_bytes, cudaStream_t s) {
  switch (out_dtype) {
    case 1:
      return launch<Tin, __nv_bfloat16>(P, grid, threads, smem_bytes, s);
    case 2:
      return launch<Tin, int8_t>(P, grid, threads, smem_bytes, s);
    default:
      return launch<Tin, float>(P, grid, threads, smem_bytes, s);
  }
}

}  // namespace

// geom (int64, 3-D after the wrapper's leading-axis padding):
//   [0:3] in_stride  [3:6] out_stride  [6:9] tile  [9:12] lo_w  [12:15] win
//   [15] sweep  [16] nswp  [17] ntiles_c0  [18] ntiles_c1  [19] pipelined
//   [20] T  [21] threads  [22] input dtype  [23:26] n_true  [26:29] dom
//   [29] output dtype  [30] in_quant set  [31] periodic
//   (dtype codes: 0 = float32, 1 = bfloat16, 2 = int8)
// stage_geom: 15 ints per stage: lo[3], hi[3], sfx_lo[3], ext[3], frontier
// depth, rounding (0 f32, 1 bf16, 2 quantized), non-periodic boundary.
// stage_q: (scale, zero point) per stage, then the input's.
// tap_begin: T + 1 prefix counts; tap_off: 3 ints per tap (axis order);
// tap_w: one float per tap; sched: 3 ints per entry, n_warm warm-up entries
// then n_steady steady ones.  bc_begin: T + 1 prefix counts of the rows of
// `bc`, the device table of correction terms (12 int32 per row, see
// kernels/sweep.py::_bc_table).  smem_bytes must equal the layout computed
// here (repro_torch.core.tiling.sweep_smem_bytes); -1 means it does not,
// -2 that stages, taps, schedule or correction terms exceed the fixed
// tables.  Otherwise the return is cudaGetLastError() after the launch.
extern "C" int sweep_chain_launch(const long long* geom, const int* stage_geom,
                                  const float* stage_q, const int* tap_begin,
                                  const int* tap_off, const float* tap_w,
                                  const int* sched, int n_warm, int n_steady,
                                  const int* bc_begin, const void* bc,
                                  const void* in, void* out, int smem_bytes,
                                  void* stream) {
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
  const int in_dtype = static_cast<int>(geom[22]);
  const int out_dtype = static_cast<int>(geom[29]);
  P.in_quant = static_cast<int>(geom[30]);
  P.periodic = static_cast<int>(geom[31]);
  if (P.T < 1 || P.T > kMaxStages || tap_begin[P.T] > kMaxTaps ||
      n_warm + n_steady > kMaxSched || bc_begin[P.T] > kMaxBc)
    return -2;
  for (int i = 0; i < 3 * (n_warm + n_steady); ++i)
    if (sched[i] < -32768 || sched[i] > 32767) return -2;
  P.n_warm = n_warm;
  P.n_steady = n_steady;
  const int t_s = P.tile[P.sweep];
  P.h_s = P.win[P.sweep] - t_s;
  P.rows = P.win[P.sweep] + (P.pipelined ? t_s : 0);
  const int esize = in_dtype == 2 ? 1 : (in_dtype == 1 ? 2 : 4);
  long long need = align16(static_cast<long long>(P.rows) * P.win[P.c0] *
                           P.win[P.c1] * esize);
  for (int j = 0; j < P.T; ++j) {
    const int* sg = stage_geom + 15 * j;
    for (int i = 0; i < 3; ++i) {
      P.st_lo[j][i] = sg[i];
      P.st_hi[j][i] = sg[3 + i];
      P.st_sfx_lo[j][i] = sg[6 + i];
      P.st_ext[j][i] = sg[9 + i];
    }
    P.depth[j] = sg[12];
    P.round[j] = sg[13];
    P.has_bc[j] = sg[14];
    P.q_scale[j] = stage_q[2 * j];
    P.q_zp[j] = stage_q[2 * j + 1];
    if (j < P.T - 1) {
      P.foff[j] = static_cast<int>(need);
      need += align16(static_cast<long long>(P.depth[j]) *
                      P.st_ext[j][P.c0] * P.st_ext[j][P.c1] * 4);
    }
  }
  P.in_scale = stage_q[2 * P.T];
  P.in_zp = stage_q[2 * P.T + 1];
  if (need != smem_bytes || need > kSmemLimit) return -1;
  P.in = in;
  P.out = out;
  P.bc = static_cast<const int4*>(bc);
  for (int j = 0; j <= P.T; ++j) {
    P.tap_begin[j] = tap_begin[j];
    P.bc_begin[j] = bc_begin[j];
  }
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
    for (int c = 0; c < 3; ++c)
      P.sched[i][c] = static_cast<short>(sched[3 * i + c]);
  const dim3 grid(static_cast<unsigned>(ntiles_c0 * P.ntiles_c1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 1:
      return launch_out<__nv_bfloat16>(out_dtype, P, grid, threads,
                                       smem_bytes, s);
    case 2:
      return launch_out<int8_t>(out_dtype, P, grid, threads, smem_bytes, s);
    default:
      return launch_out<float>(out_dtype, P, grid, threads, smem_bytes, s);
  }
}
