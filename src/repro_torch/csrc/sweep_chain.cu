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
// What bounds it on an H100: bytes in principle, instruction rate and
// shared-memory latency in practice.  T applications of a 13-point star
// do 26·T flops per output point against 8 bytes of f32 traffic; even at
// T = 3 that is ~10 flops per byte, below the card's ~20 f32 flops per
// byte of HBM bandwidth, so the least time is the input read once plus
// the output written once at 3.35 TB/s.  The fused chain keeps the T-1
// intermediates out of device memory.  What is left per tap and output
// is one shared load, one multiply and one add (kept separate for
// bit-exactness), over the stage's extent with the halo overlap of
// neighbouring columns: about 7.5 G of them for three 13-point stages on
// a 512³ grid.
//
// What the design does about it:
// * One CTA owns one cross-axis tile column and loops over its sweep steps
//   (a CUDA grid has no order and no persistent scratch).  The input
//   window is a ring of sweep rows indexed modulo its depth (plus t_s
//   landing rows filled while the step computes, when `pipelined`);
//   frontier j is a ring of stage j's output rows: t_s + lo_{j+1} +
//   hi_{j+1} rows under "ring", the full suffix extent under "trapezoid".
//   Window rows arrive as 16-byte cp.async.cg blocks (load_rows_wide) for
//   f32, bf16 and int8 alike: one block a thread where the whole launch is
//   aligned, else one warp a row with only the unaligned ends element by
//   element.
// * 512 threads per CTA (kThreads, CHAIN_THREADS in kernels/sweep.py):
//   the window and frontiers of a 512³ T = 3 tile take ~150 KB, so one CTA
//   fits an SM, with 16 warps; at most 128 registers a thread, no spills.
// * Register blocking: a thread owns kRows = 4 consecutive sweep rows of
//   one cross position of an entry (two positions, 8 sums, for a stage
//   on the table-driven loop when the entry has more positions than the
//   block has threads).  Each source row's address is found once per item
//   (row_ptrs), so a tap costs one shared load, one multiply and one add
//   per output with the sums in flight; int32 index arithmetic, divisions
//   by a float reciprocal (FastDiv).
// * The stencil shapes the repo's operators use (the 7- and 13-point
//   stars and the 27-point box, in their own tap order) are compiled with
//   constant offsets (shape_sums): no per-tap dispatch, and loads that two
//   taps share made once.  Any other stage runs the table-driven loop,
//   whose taps (sweep offset and plane offset packed in one int, and the
//   weight: one 8-byte read of the parameter bank) are prefetched a tap
//   ahead.  Per-entry values are read from the parameter bank once per
//   entry (Entry): a read at an index held in a register is far dearer
//   than one the compiler can fold.
// * The host hands the kernel a schedule of (stage, first row, end row)
//   entries: at k = 0 the warm-up (one entry per stage over its whole
//   extent for "trapezoid"; under "ring", chunks interleaved across stages
//   so no ring is overrun), at k > 0 one entry per stage for its t_s new
//   rows.  Every element is computed by the same expression whatever the
//   schedule, so ring and trapezoid agree bit for bit.
// * The output's dtype is a run-time switch at the store, so one kernel is
//   built per input dtype.
//
// Boundary conditions: the host enumerates every correction term of every
// stage in the reference's order (per tap: the dirichlet/robin constant,
// then each combination of per-axis exit depths): a constant fires where
// the tap's read leaves the domain, a read fires where the element lies on
// the term's global planes and reads the clamped (neumann, robin) or
// mirrored (reflect) cell.  The terms add up in their own f32 sum from
// zero, which joins the tap sum once, as the reference's
// `acc + bc_terms(...)` does.  The host also lists, per stage and per
// position class (along each axis: below the stage's lo, inside, at or
// above n - hi; 27 classes), the terms that can fire there, in table
// order.  Each entry splits its cross positions, uniformly over the block,
// into the interior rectangle (class 1 along both cross axes: no term can
// fire there but along the sweep) and the frame around it.  Frame items
// come first, so the lanes that add terms fill whole warps instead of
// holding back the lanes of their warp that add none; interior items read
// no table unless the entry's rows reach a sweep face, and an entry with
// neither runs a loop without boundary code.  A thread's rows are grouped
// by class and each group applies its class's rows, stored class by class
// in device memory (two loaded at once) with the class bounds among the
// kernel's parameters.  Periodic needs no terms: the host wraps the ghost
// cells and the masks keep each stage's suffix margin [-suffix_lo, n +
// suffix_hi).
//
// Storage dtypes: frontiers stay f32 in shared memory whatever the stage
// dtype, holding the value already rounded as the reference stores it: a
// bf16 round trip, or for a quantized stage the code
// clip(rint(x / s) + zp, -128, 127) read back as (q - zp)·s, computed once
// at the store.  The domain mask zeroes the sum before it is rounded, so a
// masked element stores code zp and reads back as exact 0.  The output
// takes the last stage's type (int8 codes when it is quantized); an int8
// input (a quantized hand-off) is read as codes and dequantized with
// `in_quant` in every read of the window.
//
// Bit-exactness: each output's taps are applied in zip(offsets, weights)
// order as separate f32 multiplies and adds (built with --fmad=false), the
// correction terms in table order in their own sum, quantizing uses the
// IEEE divide and rintf (half to even), and intermediates are masked in
// global coordinates (`dom` lifts the local origin; all zeros on one
// card), so the result equals the plain stage-by-stage version in
// kernels/sweep.py bit for bit.  Only the order across outputs differs.

#include <cstring>
#include <initializer_list>
#include <type_traits>

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 512;  // = CHAIN_THREADS in kernels/sweep.py
constexpr int kRows = 4;       // sweep rows per thread (register block)
constexpr int kReach = 2;      // sweep tap offsets with an unrolled step
constexpr int kSpan = kRows + 2 * kReach;  // source rows those can read
constexpr int kClasses = 27;   // position classes: 3 per axis
constexpr int kNone = -2147483647 - 1;  // a compact term's untested role
constexpr int kMaxStages = 8;
constexpr int kMaxTaps = 160;
constexpr int kMaxSched = 96;
constexpr int kMaxBc = 4096;
// How a stage's stored value is rounded (stage_geom's rounding code).
constexpr int kRoundBf16 = 1;
constexpr int kRoundQuant = 2;

// Stage j's face band along the roles (sweep, c0, c1): a coordinate p is
// of class 0 below lo[r], 2 at or above up[r] = n - hi, else 1
// (kernels/sweep.py's position_class); n[r] the true extents; `list` the
// stage's first class-list bound.
struct Band {
  int lo[3], up[3], n[3];
  int list;
};

struct ChainParams {
  const void* in;
  void* out;
  const int4* bc;      // each class's terms in order: 2 int4 (8 ints) a row
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
  int in_quant;  // the input holds int8 codes of (in_scale, in_zp)
  int out_dtype;  // 0 float32, 1 bfloat16, 2 int8 codes
  int copy16;    // every window row copies as whole 16-byte blocks
  float in_scale, in_zp;
  int st_lo[kMaxStages][3];      // stage's own halo below
  int st_hi[kMaxStages][3];      // stage's own halo above
  int st_sfx_lo[kMaxStages][3];  // later stages' summed halo below
  int st_ext[kMaxStages][3];     // stage's computed extent per axis
  int mask_lo[kMaxStages][3];    // kept global range [mask_lo, mask_hi)
  int mask_hi[kMaxStages][3];
  int depth[kMaxStages];         // frontier ring depth (stages < T-1)
  int foff[kMaxStages];          // frontier byte offset in shared memory
  int round[kMaxStages];         // 0 f32, 1 bf16, 2 quantized
  int has_bc[kMaxStages];        // a non-periodic boundary condition
  float q_scale[kMaxStages];
  float q_zp[kMaxStages];
  int tap_begin[kMaxStages + 1];
  int shape[kMaxStages];  // kShapeTable or the compiled shape of the taps
  Band band[kMaxStages];  // each stage's face band, read by band_of
  // Per tap: the sweep offset (ring rows, top 8 bits) and the offset
  // within the source plane (c0, c1; low 24 bits), then the weight's bits:
  // one 8-byte read of the parameter bank a tap.
  int2 tap[kMaxTaps];
  short sched[kMaxSched][3];  // (stage, r0, r1), rows relative to k * t_s
  // Bounds of each (stage, class)'s rows in bc: kept here, not in device
  // memory, so a face element's first row load waits on no other load.
  unsigned short cls[kMaxStages * kClasses + 1];
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
// quantized input are dequantized (DQ).
template <typename S, bool DQ>
__device__ __forceinline__ float src_at(const ChainParams& P, const S* p) {
  const float x = to_f32(*p);
  return DQ ? dequantize(x, P.in_scale, P.in_zp) : x;
}

// A ring slot one wrap away from [0, depth).
__device__ __forceinline__ int wrap(int slot, int depth) {
  if (slot < 0) return slot + depth;
  if (slot >= depth) return slot - depth;
  return slot;
}

// The row pointers of tap_sums: rp[x][k] at the source row k - kReach rows
// from the thread's first row (ring slot m), at cross position x.
template <int X, typename S>
__device__ __forceinline__ void row_ptrs(const S* src, int depth, int plane,
                                         int m, const int (&cross)[X],
                                         const S* (&rp)[X][kSpan]) {
  int slot = m - kReach;
  while (slot < 0) slot += depth;
#pragma unroll
  for (int k = 0; k < kSpan; ++k) {
#pragma unroll
    for (int x = 0; x < X; ++x) rp[x][k] = src + slot * plane + cross[x];
    slot = slot + 1 == depth ? 0 : slot + 1;
  }
}

// One tap at the kRows rows of each of a thread's X cross positions:
// `rp[x][k]` points at the source row k - kReach rows from the thread's
// first row, at cross position x; the tap reads OS rows away and `c`
// elements across.
template <int OS, int X, typename S, bool DQ>
__device__ __forceinline__ void tap_rows(const ChainParams& P,
                                         const S* (&rp)[X][kSpan],
                                         int c, float w,
                                         float (&acc)[X][kRows]) {
#pragma unroll
  for (int x = 0; x < X; ++x)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      acc[x][i] = __fadd_rn(
          acc[x][i],
          __fmul_rn(w, src_at<S, DQ>(P, rp[x][i + OS + kReach] + c)));
}

// Operator shapes compiled with their offsets as constants: the 7- and
// 13-point stars (core/cache_fitting.py::star_stencil order: the origin,
// then per axis ±1, ±2, ...) and the 27-point box (itertools.product order)
// in the kernel's (sweep, c0, c1) frame.  A stage whose taps are one of
// them, in that order, skips the table-driven loop's per-tap dispatch, and
// loads that two taps share are made once; any other stage takes the loop.
constexpr int kShapeTable = 0, kStar1 = 1, kStar2 = 2, kBox1 = 3;

__host__ __device__ constexpr int shape_taps(int shape) {
  return shape == kStar1 ? 7 : (shape == kStar2 ? 13 : 27);
}

// Tap t's offset along role r (0 sweep, 1 c0, 2 c1) of a compiled shape.
__host__ __device__ constexpr int shape_off(int shape, int t, int r) {
  if (shape == kBox1)
    return (r == 0 ? t / 9 : (r == 1 ? t / 3 % 3 : t % 3)) - 1;
  const int reach = shape == kStar1 ? 1 : 2;
  if (t == 0) return 0;
  const int u = t - 1;
  const int k = u % (2 * reach) / 2 + 1;
  return u / (2 * reach) == r ? (u % 2 ? k : -k) : 0;
}

// The f32 tap sums of stage j at kRows consecutive rows of X cross
// positions: `m` is the ring slot of the first row in the source ring,
// `cross[x]` each position's offset within a source plane, `nr` how many
// of the rows the entry holds (the rest are computed from in-range slots
// and dropped).  Each source row's address is found once; a tap then
// costs one shared load, one multiply and one add per output, with X·kRows
// sums in flight.  Sweep offsets beyond kReach take a slower path that
// wraps each row's slot.
template <int X, typename S, bool DQ>
__device__ __forceinline__ void tap_sums(const ChainParams& P, int q0,
                                         int q1, const S* src, int depth,
                                         int plane, int m,
                                         const int (&cross)[X], int nr,
                                         float (&acc)[X][kRows]) {
  const S* rp[X][kSpan];
  row_ptrs<X, S>(src, depth, plane, m, cross, rp);
#pragma unroll
  for (int x = 0; x < X; ++x)
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[x][i] = 0.0f;
  // Each tap's parameters are read one tap ahead, off the latency chain.
  int2 next = P.tap[q0];
  for (int q = q0; q < q1; ++q) {
    const int2 t = next;
    if (q + 1 < q1) next = P.tap[q + 1];
    const int os = t.x >> 24;
    const int c = (t.x << 8) >> 8;
    const float w = __int_as_float(t.y);
    // A chain of uniform compares (a jump table would cost a load).
    if (os == 0) {
      tap_rows<0, X, S, DQ>(P, rp, c, w, acc);
    } else if (os == -1) {
      tap_rows<-1, X, S, DQ>(P, rp, c, w, acc);
    } else if (os == 1) {
      tap_rows<1, X, S, DQ>(P, rp, c, w, acc);
    } else if (os == -2) {
      tap_rows<-2, X, S, DQ>(P, rp, c, w, acc);
    } else if (os == 2) {
      tap_rows<2, X, S, DQ>(P, rp, c, w, acc);
    } else {
      const int s0 = wrap(m + os, depth);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < nr) {
          int s = s0 + i;
          if (s >= depth) s -= depth;
#pragma unroll
          for (int x = 0; x < X; ++x)
            acc[x][i] = __fadd_rn(
                acc[x][i],
                __fmul_rn(w, src_at<S, DQ>(P, src + s * plane + cross[x] + c)));
        }
      }
    }
  }
}

// tap_sums for a stage of compiled shape SH: every tap unrolled, its
// offsets constants, its weight the stage's q0 + t-th in the table.
template <int SH, int X, typename S, bool DQ>
__device__ __forceinline__ void shape_sums(const ChainParams& P, int q0,
                                           const S* src, int depth,
                                           int plane, int w1, int m,
                                           const int (&cross)[X],
                                           float (&acc)[X][kRows]) {
  const S* rp[X][kSpan];
  row_ptrs<X, S>(src, depth, plane, m, cross, rp);
#pragma unroll
  for (int x = 0; x < X; ++x)
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[x][i] = 0.0f;
#pragma unroll
  for (int t = 0; t < shape_taps(SH); ++t) {
    const int os = shape_off(SH, t, 0);
    const int c = shape_off(SH, t, 1) * w1 + shape_off(SH, t, 2);
    const float w = __int_as_float(P.tap[q0 + t].y);
#pragma unroll
    for (int x = 0; x < X; ++x)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[x][i] = __fadd_rn(
            acc[x][i],
            __fmul_rn(w, src_at<S, DQ>(P, rp[x][i + os + kReach] + c)));
  }
}

// Stage j's band, read at a constant index: a parameter-bank read at an
// index held in a register costs far more than one the compiler can fold.
__device__ __forceinline__ Band band_of(const ChainParams& P, int j) {
  switch (j) {
    case 0: return P.band[0];
    case 1: return P.band[1];
    case 2: return P.band[2];
    case 3: return P.band[3];
    case 4: return P.band[4];
    case 5: return P.band[5];
    case 6: return P.band[6];
    default: return P.band[7];
  }
}

__device__ __forceinline__ int pos_class(const Band& B, int r, int p) {
  if (p < B.lo[r]) return 0;
  return p >= B.up[r] ? 2 : 1;
}

// One correction term (row a, b of P.bc) at the rows of a thread in
// `mask` (bit i: row i, at global sweep coordinate gs + i and source ring
// slot srow[i]), at the cross position (p1, p2), added to add[i].  A row
// (kernels/sweep.py::_bc_table) is the term's kind, its tested value per
// role (kNone: no test on that role) and the corrected read's offsets and
// coefficient: a constant fires where a tested offset leaves the domain, a
// read where every tested plane holds.  No branch: every corrected read
// lies in the stage's halo (the wrapper checks it), so it is loaded at any
// row and used where the term fires; a constant's row reads the element
// itself and uses nothing of it.
template <typename S, bool DQ>
__device__ __forceinline__ void bc_term(const ChainParams& P, const Band& B,
                                        const int4& a, const int4& b,
                                        const S* src, int depth, int plane,
                                        const int (&srow)[kRows], int cross,
                                        int gs, int p1, int p2, unsigned mask,
                                        float (&add)[kRows]) {
  const bool cst = a.x == 0;
  const bool cross_fires =
      cst ? (a.z != kNone && (p1 + a.z < 0 || p1 + a.z >= B.n[1])) ||
                (a.w != kNone && (p2 + a.w < 0 || p2 + a.w >= B.n[2]))
          : (a.z == kNone || p1 == a.z) && (a.w == kNone || p2 == a.w);
  const float coef = __int_as_float(b.z);
  const S* at = src + cross + b.y;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int g = gs + i;
    const bool fire =
        (mask >> i & 1u) &&
        (cst ? cross_fires ||
                   (a.y != kNone && (g + a.y < 0 || g + a.y >= B.n[0]))
             : cross_fires && (a.y == kNone || g == a.y));
    const float v = src_at<S, DQ>(P, at + wrap(srow[i] + b.x, depth) * plane);
    const float term = cst ? coef : __fmul_rn(coef, v);
    add[i] = fire ? __fadd_rn(add[i], term) : add[i];
  }
}

// The correction terms of one class, rows [t0, t1) of P.bc, in list
// (table) order: two rows are loaded at once, so a list of n terms waits
// on ceil(n / 2) loads in turn.
template <typename S, bool DQ>
__device__ __forceinline__ void bc_rows(const ChainParams& P, const Band& B,
                                        const S* src, int depth, int plane,
                                        const int (&srow)[kRows], int cross,
                                        int gs, int p1, int p2, int t0,
                                        int t1, unsigned mask,
                                        float (&add)[kRows]) {
  for (int t = t0; t < t1; t += 2) {
    const int u = t + 1 < t1 ? t + 1 : t;
    const int4 a0 = __ldg(P.bc + 2 * t), b0 = __ldg(P.bc + 2 * t + 1);
    const int4 a1 = __ldg(P.bc + 2 * u), b1 = __ldg(P.bc + 2 * u + 1);
    bc_term<S, DQ>(P, B, a0, b0, src, depth, plane, srow, cross, gs, p1, p2,
                   mask, add);
    bc_term<S, DQ>(P, B, a1, b1, src, depth, plane, srow, cross, gs, p1, p2,
                   t + 1 < t1 ? mask : 0u, add);
  }
}

// The boundary sums of the kRows rows (nr of them held) of a thread at
// one cross position: rows are grouped by their class along the sweep, and
// each group applies its class's rows once.  Class (1, 1, 1) has none.
// Each group's bounds come from the parameter bank.
template <typename S, bool DQ>
__device__ __forceinline__ void bc_block(const ChainParams& P, const Band& B,
                                         const S* src,
                                         int depth, int plane, int m,
                                         int cross, int gs, int p1, int p2,
                                         int nr, float (&add)[kRows]) {
  unsigned rows0 = 0u, rows1 = 0u, rows2 = 0u;
  int srow[kRows];
  int slot = m;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    add[i] = 0.0f;
    srow[i] = slot;
    slot = slot + 1 == depth ? 0 : slot + 1;
    const int c = pos_class(B, 0, gs + i);
    const unsigned bit = i < nr ? 1u << i : 0u;
    rows0 |= c == 0 ? bit : 0u;
    rows1 |= c == 1 ? bit : 0u;
    rows2 |= c == 2 ? bit : 0u;
  }
  const int k12 = 3 * pos_class(B, 1, p1) + pos_class(B, 2, p2);
  if (k12 == 4) rows1 = 0u;  // the class (1, 1, 1)
  const int k = B.list + k12;
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    const unsigned rows = c == 0 ? rows0 : (c == 1 ? rows1 : rows2);
    const int t0 = rows ? P.cls[k + 9 * c] : 0;
    const int t1 = rows ? P.cls[k + 9 * c + 1] : 0;
    if (t0 < t1)
      bc_rows<S, DQ>(P, B, src, depth, plane, srow, cross, gs, p1, p2, t0,
                     t1, rows, add);
  }
}

// What every thread of the block knows of one schedule entry: stage j
// over rows [r0, r1) (relative to the step's first output row g_step) and
// its whole cross extent.
struct Entry {
  int j, r0, r1, g_step, base_c0, base_c1;
  int e0, e1, plane_e, nchunks;
  int src_w1, src_plane, src_depth, src_origin;
  int gs0, go0, go1;  // global coordinates of the first row and column
  bool last, has_bc;
  bool sweep_face;  // a row of the entry lies in the sweep's face band
  // The interior rectangle [a0, b0) x [a1, b1) of the entry's cross
  // positions: class 1 along both cross axes (empty: a0 = b0 = e0).
  int a0, b0, a1, b1;
  FastDiv by_e1, by_src_depth, by_depth;
  // The kept global range along (sweep, c0, c1), the stored rounding, and
  // where the result goes: frontier j (its byte offset, and the offset
  // of global rows in its ring) or the output (element strides).
  int mlo_s, mhi_s, mlo_0, mhi_0, mlo_1, mhi_1;
  int rnd;
  float qs, qz;
  int foff, sfx_s;
  long long os_s, os_0, os_1;
  int lo0, lo1;  // the stage's own halo below along c0, c1
  int tap0, tap1;  // the stage's taps
  int shape;                       // kShapeTable or a compiled shape
};

// The output element `idx` at the output's dtype (P.out_dtype).
__device__ __forceinline__ void store_out(const ChainParams& P, long long idx,
                                          float v) {
  if (P.out_dtype == 1)
    static_cast<__nv_bfloat16*>(P.out)[idx] = from_f32<__nv_bfloat16>(v);
  else if (P.out_dtype == 2)
    static_cast<int8_t*>(P.out)[idx] = from_f32<int8_t>(v);
  else
    static_cast<float*>(P.out)[idx] = v;
}

// The boundary sum (where FACE and `face`: the element may have terms),
// domain mask, rounding and store of kRows outputs at one cross position
// (x0, x1) of the entry; `c` is the thread's row chunk.
template <bool FACE, typename S, bool DQ>
__device__ __forceinline__ void finish(const ChainParams& P, const Entry& E,
                                       unsigned char* smem, const S* src,
                                       float (&acc)[kRows], int c, int x0,
                                       int x1, int m, int cross, int nr,
                                       bool face) {
  const int j = E.j;
  const int g = E.g_step + E.r0 + c * kRows;
  const int gs = E.gs0 + c * kRows;
  if (FACE && face) {
    const Band B = band_of(P, j);
    float add[kRows];
    bc_block<S, DQ>(P, B, src, E.src_depth, E.src_plane, m, cross, gs,
                    E.go0 + x0, E.go1 + x1, nr, add);
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = __fadd_rn(acc[i], add[i]);
  } else if (E.has_bc) {
    // The reference adds its (here all-zero) correction sum everywhere:
    // -0 + 0 is +0.
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = __fadd_rn(acc[i], 0.0f);
  }
  if (E.last) {
    const long long o = g * E.os_s + (E.base_c0 + x0) * E.os_0 +
                        (E.base_c1 + x1) * E.os_1;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < nr) {
        float v = acc[i];
        if (E.rnd == kRoundQuant) v = quantize_code(v, E.qs, E.qz);
        store_out(P, o + i * E.os_s, v);
      }
    }
    return;
  }
  float* front = reinterpret_cast<float*>(smem + E.foff);
  const int p0 = E.go0 + x0, p1 = E.go1 + x1;
  const bool cross_kept =
      p0 >= E.mlo_0 && p0 < E.mhi_0 && p1 >= E.mlo_1 && p1 < E.mhi_1;
  const int depth = E.by_depth.d;
  int fs;
  divide(g + E.sfx_s, E.by_depth, fs);
  float* f = front + x0 * E.e1 + x1;
  const int fplane = E.e0 * E.e1;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < nr) {
      const bool inside = cross_kept && gs + i >= E.mlo_s && gs + i < E.mhi_s;
      float v = inside ? acc[i] : 0.0f;
      if (E.rnd == kRoundBf16) {
        v = __bfloat162float(__float2bfloat16_rn(v));
      } else if (E.rnd == kRoundQuant) {
        v = dequantize(quantize_code(v, E.qs, E.qz), E.qs, E.qz);
      }
      f[fs * fplane] = v;
      fs = fs + 1 == depth ? 0 : fs + 1;
    }
  }
}

// Frame position i of the entry (the cross positions outside its
// interior rectangle, row by row): the rows above the rectangle, the
// side columns of the rows beside it, then the rows below.
__device__ __forceinline__ void frame_pos(const Entry& E, int i,
                                          const FastDiv& by_side, int& x0,
                                          int& x1) {
  const int top = E.a0 * E.e1;
  const int mid = (E.b0 - E.a0) * (E.e1 - (E.b1 - E.a1));
  if (i < top) {
    x0 = divide(i, E.by_e1, x1);
  } else if (i < top + mid) {
    int r;
    x0 = E.a0 + divide(i - top, by_side, r);
    x1 = r < E.a1 ? r : r + (E.b1 - E.a1);
  } else {
    x0 = E.b0 + divide(i - top - mid, E.by_e1, x1);
  }
}

// The entry's work, split into items of kRows rows at X cross positions
// half = ceil(n / X) apart (a position past its region repeats the item's
// first and is not stored).  An entry where no term can fire (FR false)
// has one region, the whole plane, and no boundary code.  Otherwise the
// frame's items come first, then the interior rectangle's (which has
// terms only where the entry's rows reach a sweep face): a frame item is
// the longest of the entry, so it starts first.
template <int X, bool FR, typename S, bool DQ>
__device__ void entry_items(const ChainParams& P, const Entry& E,
                            unsigned char* smem, const S* src) {
  const int w_in = FR ? E.b1 - E.a1 : E.e1;
  const int n_in = FR ? (E.b0 - E.a0) * w_in : E.plane_e;
  const int n_fr = FR ? E.plane_e - n_in : 0;
  const int half_in = (n_in + X - 1) / X, half_fr = (n_fr + X - 1) / X;
  const int items_fr = E.nchunks * half_fr;
  const FastDiv by_half_in = make_div(max(half_in, 1));
  const FastDiv by_half_fr = make_div(max(half_fr, 1));
  const FastDiv by_w_in = make_div(max(w_in, 1));
  const FastDiv by_side = make_div(max(E.e1 - w_in, 1));
  const int lo0 = E.lo0, lo1 = E.lo1;
  for (int u = threadIdx.x; u < items_fr + E.nchunks * half_in;
       u += blockDim.x) {
    const bool frame = FR && u < items_fr;
    const int n = frame ? n_fr : n_in, half = frame ? half_fr : half_in;
    int pp, m;
    const int c = frame ? divide(u, by_half_fr, pp)
                        : divide(u - items_fr, by_half_in, pp);
    const int nr = min(kRows, E.r1 - E.r0 - c * kRows);
    divide(E.g_step + E.r0 + c * kRows + E.src_origin, E.by_src_depth, m);
    int x0[X], x1[X], cross[X];
#pragma unroll
    for (int x = 0; x < X; ++x) {
      const int i = pp + x * half < n ? pp + x * half : pp;
      if (!FR) {
        x0[x] = divide(i, E.by_e1, x1[x]);
      } else if (frame) {
        frame_pos(E, i, by_side, x0[x], x1[x]);
      } else {
        x0[x] = E.a0 + divide(i, by_w_in, x1[x]);
        x1[x] += E.a1;
      }
      cross[x] = (x0[x] + lo0) * E.src_w1 + x1[x] + lo1;
    }
    float acc[X][kRows];
    constexpr bool kShaped = X == 1 && std::is_same<S, float>::value;
    if (kShaped && E.shape == kStar2)
      shape_sums<kStar2, X, S, DQ>(P, E.tap0, src, E.src_depth, E.src_plane,
                                   E.src_w1, m, cross, acc);
    else if (kShaped && E.shape == kStar1)
      shape_sums<kStar1, X, S, DQ>(P, E.tap0, src, E.src_depth, E.src_plane,
                                   E.src_w1, m, cross, acc);
    else if (kShaped && E.shape == kBox1)
      shape_sums<kBox1, X, S, DQ>(P, E.tap0, src, E.src_depth, E.src_plane,
                                  E.src_w1, m, cross, acc);
    else
      tap_sums<X, S, DQ>(P, E.tap0, E.tap1, src, E.src_depth, E.src_plane,
                         m, cross, nr, acc);
#pragma unroll
    for (int x = 0; x < X; ++x)
      if (x == 0 || pp + x * half < n)
        finish<FR, S, DQ>(P, E, smem, src, acc[x], c, x0[x], x1[x], m,
                          cross[x], nr, frame || E.sweep_face);
  }
}

// Stage j over rows [r0, r1) (relative to the step's first output row
// g_step) and its whole cross extent, reading `src`: the window ring
// (j == 0, element type S = Tin, dequantized when DQ) or frontier j - 1.
// Two cross positions a thread for a table-driven stage whose entry has
// more items than the block has threads.
template <typename S, bool DQ>
__device__ void run_entry(const ChainParams& P, unsigned char* smem,
                          const S* src, int j, int r0, int r1, int g_step,
                          int base_c0, int base_c1) {
  const int s = P.sweep, c0 = P.c0, c1 = P.c1;
  Entry E;
  E.j = j;
  E.r0 = r0;
  E.r1 = r1;
  E.g_step = g_step;
  E.base_c0 = base_c0;
  E.base_c1 = base_c1;
  E.e0 = P.st_ext[j][c0];
  E.e1 = P.st_ext[j][c1];
  E.plane_e = E.e0 * E.e1;
  E.nchunks = (r1 - r0 + kRows - 1) / kRows;
  if (j == 0) {
    E.src_w1 = P.win[c1];
    E.src_plane = P.win[c0] * E.src_w1;
    E.src_depth = P.rows;
    E.src_origin = P.lo_w[s];
  } else {
    E.src_w1 = P.st_ext[j - 1][c1];
    E.src_plane = P.st_ext[j - 1][c0] * E.src_w1;
    E.src_depth = P.depth[j - 1];
    E.src_origin = P.st_sfx_lo[j - 1][s];
  }
  E.last = j == P.T - 1;
  E.gs0 = P.dom[s] + g_step + r0;
  E.go0 = P.dom[c0] + base_c0 - P.st_sfx_lo[j][c0];
  E.go1 = P.dom[c1] + base_c1 - P.st_sfx_lo[j][c1];
  E.has_bc = P.has_bc[j];
  // The same for every thread: where correction terms can fire.
  E.sweep_face = false;
  E.a0 = E.a1 = 0;
  E.b0 = E.e0;
  E.b1 = E.e1;
  if (E.has_bc) {
    const Band B = band_of(P, j);
    E.sweep_face = E.gs0 < B.lo[0] || E.gs0 + (r1 - r0) > B.up[0];
    E.a0 = min(max(B.lo[1] - E.go0, 0), E.e0);
    E.b0 = min(max(B.up[1] - E.go0, E.a0), E.e0);
    E.a1 = min(max(B.lo[2] - E.go1, 0), E.e1);
    E.b1 = min(max(B.up[2] - E.go1, E.a1), E.e1);
    if (E.a0 == E.b0 || E.a1 == E.b1) {  // no interior: all frame rows
      E.a0 = E.b0 = E.e0;
      E.a1 = 0;
      E.b1 = E.e1;
    }
  }
  E.by_e1 = make_div(E.e1);
  E.by_src_depth = make_div(E.src_depth);
  E.by_depth = make_div(E.last ? 1 : P.depth[j]);
  E.mlo_s = P.mask_lo[j][s];
  E.mhi_s = P.mask_hi[j][s];
  E.mlo_0 = P.mask_lo[j][c0];
  E.mhi_0 = P.mask_hi[j][c0];
  E.mlo_1 = P.mask_lo[j][c1];
  E.mhi_1 = P.mask_hi[j][c1];
  E.rnd = P.round[j];
  E.qs = P.q_scale[j];
  E.qz = P.q_zp[j];
  E.foff = P.foff[j];
  E.sfx_s = P.st_sfx_lo[j][s];
  E.os_s = P.out_stride[s];
  E.os_0 = P.out_stride[c0];
  E.os_1 = P.out_stride[c1];
  E.lo0 = P.st_lo[j][c0];
  E.lo1 = P.st_lo[j][c1];
  E.tap0 = P.tap_begin[j];
  E.tap1 = P.tap_begin[j + 1];
  E.shape = P.shape[j];
  // A compiled shape has no per-tap dispatch to share between positions,
  // and at two positions it would need more than 128 registers.
  const bool two = E.shape == kShapeTable &&
                   E.nchunks * E.plane_e > static_cast<int>(blockDim.x);
  const bool frame = (E.b0 - E.a0) * (E.b1 - E.a1) < E.plane_e ||
                     E.sweep_face;
  if (two && frame)
    entry_items<2, true, S, DQ>(P, E, smem, src);
  else if (two)
    entry_items<2, false, S, DQ>(P, E, smem, src);
  else if (frame)
    entry_items<1, true, S, DQ>(P, E, smem, src);
  else
    entry_items<1, false, S, DQ>(P, E, smem, src);
  __syncthreads();
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads, 1)
    sweep_chain_kernel(const __grid_constant__ ChainParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc1 = blockIdx.x % P.ntiles_c1;
  const int tc0 = blockIdx.x / P.ntiles_c1;
  const int base_c0 = tc0 * P.tile[P.c0];
  const int base_c1 = tc1 * P.tile[P.c1];
  const int t_s = P.tile[P.sweep];
  const Tin* in = static_cast<const Tin*>(P.in);
  Tin* ring = reinterpret_cast<Tin*>(smem);

  for (int k = 0; k < P.nswp; ++k) {
    window_step(k, P.nswp, t_s, P.h_s, P.pipelined,
                [&](long long g0, int n) {
                  load_rows_wide(P, in, ring, g0, n, base_c0, base_c1);
                });
    const int g_step = k * t_s;
    const int first = k == 0 ? 0 : P.n_warm;
    const int end = k == 0 ? P.n_warm : P.n_warm + P.n_steady;
    for (int i = first; i < end; ++i) {
      const int j = P.sched[i][0], r0 = P.sched[i][1], r1 = P.sched[i][2];
      if (j > 0) {
        run_entry<float, false>(
            P, smem, reinterpret_cast<const float*>(smem + P.foff[j - 1]), j,
            r0, r1, g_step, base_c0, base_c1);
      } else if (std::is_same<Tin, int8_t>::value && P.in_quant) {
        // Only int8 codes are dequantized (the wrapper refuses others).
        run_entry<Tin, true>(P, smem, ring, 0, r0, r1, g_step, base_c0,
                             base_c1);
      } else {
        run_entry<Tin, false>(P, smem, ring, 0, r0, r1, g_step, base_c0,
                              base_c1);
      }
    }
  }
}

using KernelFn = decltype(&sweep_chain_kernel<float>);

// The kernel instantiation for the input dtype code, with its dynamic
// shared memory raised to smem_bytes.
KernelFn pick(int in_dtype, int smem_bytes, cudaError_t* err) {
  KernelFn fn = in_dtype == 1   ? sweep_chain_kernel<__nv_bfloat16>
                : in_dtype == 2 ? sweep_chain_kernel<int8_t>
                                : sweep_chain_kernel<float>;
  *err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  return fn;
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
// `bc`, the device table of correction terms (rows of 8 int32,
// kernels/sweep.py::_bc_table) class by class, each class's rows in its
// list's order (kernels/sweep.py::_bc_classes), and `bc_bounds` the T * 27
// + 1 bounds of the classes in it (host memory).  threads must
// be kThreads.  smem_bytes must equal the layout computed here
// (repro_torch.core.tiling.sweep_smem_bytes); -1 means it does not, -2
// that stages, taps, schedule or correction terms exceed the fixed tables,
// -3 that threads is not kThreads (-2 also when the padded sweep axis
// reaches 2^22 rows).  Otherwise the return is the CUDA error
// of the launch (0 when it was taken).
extern "C" int sweep_chain_launch(const long long* geom, const int* stage_geom,
                                  const float* stage_q, const int* tap_begin,
                                  const int* tap_off, const float* tap_w,
                                  const int* sched, int n_warm, int n_steady,
                                  const int* bc_begin, const void* bc,
                                  const int* bc_bounds, const void* in,
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
  const int in_dtype = static_cast<int>(geom[22]);
  P.out_dtype = static_cast<int>(geom[29]);
  P.in_quant = static_cast<int>(geom[30]);
  const bool periodic = geom[31] != 0;
  if (threads != kThreads) return -3;
  if (P.T < 1 || P.T > kMaxStages || tap_begin[P.T] > kMaxTaps ||
      n_warm + n_steady > kMaxSched || bc_begin[P.T] > kMaxBc)
    return -2;
  for (int i = 0; i < 3 * (n_warm + n_steady); ++i)
    if (sched[i] < -32768 || sched[i] > 32767) return -2;
  // Rows and items are divided as floats (FastDiv): exact below 2^22.
  if (geom[16] * geom[6 + geom[15]] + geom[12 + geom[15]] >= (1 << 22))
    return -2;
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
      // Intermediates are kept on the true domain, widened by the stage's
      // suffix margin under periodic wrap.
      P.mask_lo[j][i] = periodic ? -P.st_sfx_lo[j][i] : 0;
      P.mask_hi[j][i] =
          P.n_true[i] +
          (periodic ? P.st_ext[j][i] - P.tile[i] - P.st_sfx_lo[j][i] : 0);
    }
    const int ax[3] = {P.sweep, P.c0, P.c1};
    for (int r = 0; r < 3; ++r) {
      P.band[j].lo[r] = P.st_lo[j][ax[r]];
      P.band[j].up[r] = P.n_true[ax[r]] - P.st_hi[j][ax[r]];
      P.band[j].n[r] = P.n_true[ax[r]];
    }
    P.band[j].list = j * kClasses;
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
  // The window copies as whole 16-byte blocks when every row starts
  // aligned in global and shared memory and is a whole number of blocks.
  const auto aligned = [](long long bytes) { return bytes % 16 == 0; };
  P.copy16 = P.in_stride[P.c1] == 1 &&
             aligned(reinterpret_cast<long long>(in)) &&
             aligned(P.in_stride[P.sweep] * esize) &&
             aligned(P.in_stride[P.c0] * esize) &&
             aligned(static_cast<long long>(P.tile[P.c1]) * esize) &&
             aligned(static_cast<long long>(P.win[P.c1]) * esize);
  P.in = in;
  P.out = out;
  P.bc = static_cast<const int4*>(bc);
  if (bc_bounds[P.T * kClasses] > 65535) return -2;
  for (int i = 0; i <= P.T * kClasses; ++i)
    P.cls[i] = static_cast<unsigned short>(bc_bounds[i]);
  for (int j = 0; j <= P.T; ++j) P.tap_begin[j] = tap_begin[j];
  for (int j = 0; j < P.T; ++j) {
    // A stage reads the window (j == 0) or the previous frontier.
    const int src_w1 = j == 0 ? P.win[P.c1] : P.st_ext[j - 1][P.c1];
    for (int q = tap_begin[j]; q < tap_begin[j + 1]; ++q) {
      const int* o = tap_off + 3 * q;
      const int oc = o[P.c0] * src_w1 + o[P.c1];
      if (oc < -(1 << 23) || oc >= (1 << 23) || o[P.sweep] < -128 ||
          o[P.sweep] > 127)
        return -2;
      int wbits;
      memcpy(&wbits, tap_w + q, sizeof(wbits));
      P.tap[q] = make_int2(
          static_cast<int>(static_cast<unsigned>(o[P.sweep]) << 24 |
                           (static_cast<unsigned>(oc) & 0xFFFFFFu)),
          wbits);
    }
  }
  for (int j = 0; j < P.T; ++j) {
    P.shape[j] = kShapeTable;
    const int n = tap_begin[j + 1] - tap_begin[j];
    for (int sh : {kStar1, kStar2, kBox1}) {
      bool same = n == shape_taps(sh);
      for (int t = 0; same && t < n; ++t) {
        const int* o = tap_off + 3 * (tap_begin[j] + t);
        same = o[P.sweep] == shape_off(sh, t, 0) &&
               o[P.c0] == shape_off(sh, t, 1) &&
               o[P.c1] == shape_off(sh, t, 2);
      }
      if (same) P.shape[j] = sh;
    }
  }
  for (int i = 0; i < n_warm + n_steady; ++i)
    for (int c = 0; c < 3; ++c)
      P.sched[i][c] = static_cast<short>(sched[3 * i + c]);
  cudaError_t err;
  KernelFn fn = pick(in_dtype, smem_bytes, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(ntiles_c0 * P.ntiles_c1));
  void* args[] = {&P};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid,
                         dim3(kThreads), args, smem_bytes,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the input dtype's instantiation resident on one SM at
// `smem_bytes` of dynamic shared memory and kThreads threads, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative value is the
// negated CUDA error.
extern "C" int sweep_chain_occupancy(int in_dtype, int smem_bytes) {
  cudaError_t err;
  KernelFn fn = pick(in_dtype, smem_bytes, &err);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                        smem_bytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Threads per CTA the chain kernel is built for (its __launch_bounds__).
extern "C" int sweep_chain_threads() { return kThreads; }
