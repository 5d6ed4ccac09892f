// Fleet-fused ADMM: every iteration of every candidate QP of a cycle in
// one launch (sm_90a).
//
// Replaces the TPU kernel intent_mpc_tpu/ops/pallas_fused.py::_fleet_kernel
// (:300-413, launched by fleet_solve :416-495). Per scenario s and live
// candidate c (inputs packed by intent_mpc_torch/ops/fleet.py::pack_fleet,
// layout (S, 8, rows), slot 6 and 7 inert; the obstacle arrays as one
// record tensor, fleet.py::pack_obstacle_records):
//
//   a_s(x)  = (E * A_ext (D x))[lin rows],  obstacle rows from the copy rows
//   at_s(w) = D * A_ext^T [E * w_lin | sum_k w_obs * g]
//   x0 -> (zl, zo) = a_s(x0), yl = yo = 0; then `iters` times:
//     rhs = sigma x - q + at_s(rl zl - yl, ro zo - yo)
//     xt  = Minv rhs;  `refine` times: xt += Minv (rhs - (hs xt + at_s(r * a_s(xt))))
//     (ztl, zto) = a_s(xt);  x = alpha xt + (1 - alpha) x
//     zr = alpha zt + (1 - alpha) z;  z = clip(zr + y / rho, lo, hi);  y += rho (zr - z)
//   and returns the scaled x, y_lin and y_obs.
//
// What bounds it on the H100. The function's own work is float32
// operations (~1.2 ms at 128 scenarios and 67 TFLOP/s). The design cannot
// keep a scenario's Minv (n = 385 live rows of 388 columns, 597 KB) or its
// obstacle records (6 x 29 x 72 slots of 32 B, 401 KB) on an SM, so per
// iteration at refine 2 it streams Minv three times and the records three
// times, plus z_obs and y_obs read and written once in device memory:
// ~3.2 MB per scenario and iteration, ~41 GB per 100-iteration solve at
// 128 scenarios (76 MB of Minv and 51 MB of records, above the 50 MB L2),
// ~12 ms at 3.35 TB/s. At 32 scenarios the streams fit in L2, and the
// time is set by instruction issue and latency inside each SM (an apply
// takes several times its FMAs' cycles), with 100 of the 132 SMs idle
// (a cluster per scenario is the later answer).
//
// Design. One 512-thread block per scenario runs the whole solve;
// scenarios are independent, so there is no grid-wide synchronisation, no
// atomics, and the solve is one launch. The live candidates' vectors (x,
// x-tilde, rhs, the residual, d, the A_ext image and the linear-row z and
// y) sit in shared memory at a stride of n rounded up to 4.
//  * Minv apply: the rows come in sets of 8; warp w owns sets w, w + 16,
//    ... (3 or 4 at n = 385) and streams their rows through its own ring
//    of kStages shared-memory chunks of kCh float4 columns with cp.async,
//    one chunk ahead. A quad of lanes owns a row of each set, each lane a
//    quarter of the columns, so one shared-memory read of a vector float4
//    feeds up to 4 rows x 4 FMAs; the quad adds its partial sums at the
//    end. The next apply's first chunk is issued at the end of each apply,
//    so it loads while the row phases run. No block barrier inside an
//    apply.
//  * Obstacle rows: the wrapper packs the eight read-only per-slot arrays
//    into two float4 per slot; a group of 8 lanes owns one (candidate,
//    step) row, walks the K slots (K is a multiple of 8, so no lane idles
//    on a last trip) with kBatch slots' records in flight per lane, and
//    reduces the five A^T sums with shuffles in a fixed order.
//  * Latency: the CSR arrays of A_ext and A_ext^T and d sit in shared
//    memory; the other small per-row inputs come from L2 (the ring leaves
//    L1 little room), kept there by an evict-first policy on the Minv and
//    record streams. Each CSR walk takes all six candidates at once, one
//    thread per row, so their loads are in flight together.
//  * Fused phases: the d scaling rides the A_ext gather; the A_ext^T
//    gather carries the rhs or the residual update; the x blend is folded
//    into the next rhs. Twelve block barriers per iteration at refine 2.
//  * z_obs and y_obs live in device memory (y_obs in the output): at the
//    production shapes (6 x 29 x 72 slots, 100 KB each) the ring and the
//    vectors leave no room for them in shared memory, and 49 more
//    registers per thread do not fit beside the apply's accumulators.
// A_ext (792 x 512, ~1.3k nonzeros) and its transpose are CSR arrays (built
// on the host from the same numpy construction, columns ascending).
//
// Precision: every product is IEEE float32 on the CUDA cores, with
// explicit __fmaf_rn in the Minv and A_ext dot products (the library is
// built with -fmad=false, which only stops the compiler from contracting
// a*b + c on its own). The elementwise updates stay uncontracted, in the
// plain version's order. No TF32 and no tensor cores: on these QPs the
// duals ramp to 1e4-1e5 while x stays ~1e1, and every cheaper precision
// diverged on the TPU (pallas_fused.py:264-272). Every sum has a fixed
// order, so the kernel is deterministic. Non-finite values propagate along
// the nonzeros of A_ext (the plain version's dense product would spread
// them over the whole candidate at once); the next dense Minv apply does
// the same, so a broken candidate still ends non-finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;     // candidate slots per scenario in the layout
constexpr int kLive = 6;      // live candidates (slots 6, 7 are inert)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 4;     // lanes sharing a Minv row, a quarter of its columns each
constexpr int kCh = 2 * kQuads;  // float4 columns of Minv per ring chunk
constexpr int kStages = 2;    // chunks per warp ring
static_assert(kCh == kQuads || kCh == 2 * kQuads, "see swizzle");
static_assert(32 % kCh == 0, "a lane copies one column of each chunk");
constexpr int kSetRows = 32 / kQuads;  // Minv rows of a row set, one per lane quad
constexpr int kMaxSets = 4;   // row sets per warp: n <= 512
constexpr int kGroup = 8;     // lanes per obstacle row
constexpr int kRowsPerWarp = 32 / kGroup;
constexpr int kBatch = 3;     // obstacle slots per lane loaded together
constexpr unsigned kFull = 0xffffffffu;
// shared memory a block can use, less the cycle count's static array
constexpr size_t kSmemLimit = 232448 - 64;

struct FleetArgs {
  const int* a_ptr;     // CSR of A_ext: n_ext + 1 row pointers
  const int* a_col;
  const float* a_val;
  const int* at_ptr;    // CSR of A_ext^T: n_pad + 1 row pointers
  const int* at_col;
  const float* at_val;
  const float* minv;    // (S, n_pad, n_pad)
  const float* d;       // (S, 8, n_pad)
  const float* q;
  const float* hs;
  const float* x0;
  const float* el;      // (S, 8, lin_pad)
  const float* rl;
  const float* irl;
  const float* lol;
  const float* hil;
  const float4* rec;    // (S, 6, W, K, 2): {gx gy gz s3}, {s4 ro iro loo}
  float* x_out;         // (S, 8, n_pad)
  float* yl_out;        // (S, 8, lin_pad)
  float* yo_out;        // (S, 8, W, K), also the y_obs iterate
  float* zo;            // (S, 6, W, K), the z_obs iterate
  long long* clk;       // (S, kPhases) phase cycles, or null (see PhaseClock)
  int S, n, n_pad, lin_pad, W, Wp, K, n_ext, iters, refine;
  int nnz;              // nonzeros of A_ext (and of its transpose)
  float sigma, alpha, beta;  // beta = 1 - alpha, rounded to float on the host
};

// Phase kinds of the optional cycle count (fleet_phases.py reads it). The
// rhs and residual updates are counted with the A_ext^T gather they ride,
// the x blend with the rhs.
enum Phase { kMinvApply, kCsrA, kCsrAt, kLinRows, kObsRows, kVecUpdate,
             kPhases };

// Thread 0 of each block adds the clock64() cycles of each phase, from the
// barrier that ends the previous phase to the one that ends this one, and
// writes them to clk[block][kind] at the end. With clk null (every caller
// but the measuring script) it does nothing. The sums (and, last, the
// clock at the previous barrier) live in shared memory, not in registers.
struct PhaseClock {
  long long* out;
  long long* acc;   // kPhases + 1 in shared memory
  __device__ PhaseClock(long long* o, long long* s) : out(o), acc(s) {
    if (out && threadIdx.x == 0) {
      for (int k = 0; k < kPhases; ++k) acc[k] = 0;
      acc[kPhases] = clock64();
    }
  }
  __device__ __forceinline__ void lap(Phase k) {
    if (out && threadIdx.x == 0) {
      const long long now = clock64();
      acc[k] += now - acc[kPhases];
      acc[kPhases] = now;
    }
  }
  __device__ void store() const {
    if (out && threadIdx.x == 0)
      for (int k = 0; k < kPhases; ++k) out[blockIdx.x * kPhases + k] = acc[k];
  }
};

// What an obstacle or linear-row pass computes from the fresh A_ext image.
enum Pass {
  kInit,    // z = a_s(x0), y = 0; emit the first rhs's A^T input
  kMApply,  // emit the A^T input of m_apply: rho * a_s(v)
  kUpdate,  // over-relaxed z/y update; emit the next rhs's A^T input
};

// The shared-memory plan; the kernel and the launcher compute it alike.
struct Plan {
  int ns;          // vector stride: n rounded up to 4
  int nsets;       // Minv row sets (kSetRows rows each)
  size_t ring;     // float4 of all warps' rings
  size_t bytes;
};

__host__ __device__ inline Plan plan(const FleetArgs& a) {
  Plan p;
  p.ns = (a.n + 3) & ~3;
  p.nsets = (a.n + kSetRows - 1) / kSetRows;
  p.ring = (size_t)p.nsets * kSetRows * kCh * kStages;
  // x, x-tilde, rhs, residual, d; A_ext image; linear z, y; both CSRs
  p.bytes = sizeof(float4) * p.ring
            + sizeof(float) * (kLive * (5 * (size_t)p.ns + a.n_ext
                                        + 2 * (size_t)a.lin_pad)
                               + (a.n_ext + 1) + (p.ns + 1) + 4 * (size_t)a.nnz);
  return p;
}

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  const float t = v < lo ? lo : v;
  return t > hi ? hi : t;
}

__device__ __forceinline__ float max_keep_nan(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Minv and the obstacle records stream through L2 marked evict-first, so
// that the small per-row inputs (the linear-row data, q, hs) stay in L2.
__device__ __forceinline__ unsigned long long stream_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void cp_async16_stream(void* smem, const void* gmem,
                                                  unsigned long long pol) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "l"(pol) : "memory");
}

// A read-only record load of the stream, evict-first in L2 (through L1:
// a slot's second float4 shares its 32-byte sector with the first).
__device__ __forceinline__ float4 ldg_stream(const float4* p,
                                             unsigned long long pol) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, "
      "[%4], %5;\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A CSR matrix in shared memory.
struct Csr {
  const int* ptr;
  const int* col;
  const float* val;
};

// Row r of A_ext applied to d * v for every live candidate (d and v at
// stride ns): the row's CSR walk is shared by the six candidates.
__device__ __forceinline__ void gather_dv(const Csr& A, int r, const float* d,
                                          const float* v, int ns,
                                          float acc[kLive]) {
#pragma unroll
  for (int c = 0; c < kLive; ++c) acc[c] = 0.0f;
  const int end = A.ptr[r + 1];
  for (int p = A.ptr[r]; p < end; ++p) {
    const int j = A.col[p];
    const float val = A.val[p];
#pragma unroll
    for (int c = 0; c < kLive; ++c)
      acc[c] = __fmaf_rn(val, d[c * ns + j] * v[c * ns + j], acc[c]);
  }
}

// Row r of A_ext^T applied to every live candidate's A_ext image.
__device__ __forceinline__ void gather_t(const Csr& T, int r, const float* sE,
                                         int n_ext, float acc[kLive]) {
#pragma unroll
  for (int c = 0; c < kLive; ++c) acc[c] = 0.0f;
  const int end = T.ptr[r + 1];
  for (int p = T.ptr[r]; p < end; ++p) {
    const int j = T.col[p];
    const float val = T.val[p];
#pragma unroll
    for (int c = 0; c < kLive; ++c)
      acc[c] = __fmaf_rn(val, sE[c * n_ext + j], acc[c]);
  }
}

// One warp's stream of its Minv rows through its ring. Row set g holds rows
// [g kSetRows, g kSetRows + kSetRows); warp w owns sets w, w + 16, ...
// Lane (quad rr, q) of the warp takes row rr of each of its sets and the
// float4 columns j = q (mod kQuads) of each chunk. A chunk stores local
// row l's float4 j at l kCh + (j ^ (l & 1) kQuads), so a quarter-warp's
// reads (rows rr, rr + 1; q = 0..3) fall on distinct banks.
struct MinvStream {
  const float* m;   // the scenario's Minv
  float4* ring;     // this warp's kStages chunks of sets x kSetRows x kCh
  unsigned long long pol;  // L2 policy of the stream
  int n, n_pad, set0, sets, nv4, nchunks;
};

__device__ __forceinline__ int swizzle(int l, int j) {
  return l * kCh + (kCh == 2 * kQuads ? j ^ ((l & 1) * kQuads) : j);
}

// Issue chunk k (float4 columns [k kCh, k kCh + kCh) of the warp's rows)
// into its ring slot and commit one cp.async group, empty past the end.
__device__ __forceinline__ void issue_chunk(const MinvStream& ms, int k) {
  if (k < ms.nchunks) {
    const int lane = threadIdx.x & 31;
    const int c0 = k * kCh;
    const int cols = min(kCh, ms.nv4 - c0);
    float4* slot = ms.ring + (k % kStages) * ms.sets * kSetRows * kCh;
    // item i = lane + 32 t: float4 f = lane % kCh of local row l = i / kCh
    const int f = lane % kCh;
#pragma unroll
    for (int t = 0; t < kMaxSets * kSetRows * kCh / 32; ++t) {
      const int l = (lane + 32 * t) / kCh;   // m kSetRows + rr
      const int m = l / kSetRows;
      const int row = (ms.set0 + kWarps * m) * kSetRows + l % kSetRows;
      if (m < ms.sets && f < cols && row < ms.n)
        cp_async16_stream(slot + swizzle(l, f),
                          ms.m + (size_t)row * ms.n_pad + 4 * (c0 + f),
                          ms.pol);
    }
  }
  cp_async_commit();
}

// out[c][i] = (out[c][i] if kAdd) + sum_{j<ns} m[i][j] * in[c][j] for the
// live rows i < n; without kAdd the pad rows n..ns-1 become 0 (the pad
// columns of Minv past n are zero, and so are in's pad rows). Each lane
// sums its quarter of a row's columns in ascending order, and the quad
// adds its four partial sums pairwise. Expects the ring's first
// kStages - 1 chunks issued; issues them again for the next apply.
template <bool kAdd>
__device__ void minv_apply(const MinvStream& ms, int ns, const float* in,
                           float* out, PhaseClock& pc) {
  const int lane = threadIdx.x & 31;
  const int q = lane % kQuads;
  const int rr = lane / kQuads;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  const int ns4 = ns >> 2;
  float acc[kMaxSets][kLive];
#pragma unroll
  for (int m = 0; m < kMaxSets; ++m)
#pragma unroll
    for (int c = 0; c < kLive; ++c) acc[m][c] = 0.0f;
  for (int k = 0; k < ms.nchunks; ++k) {
    issue_chunk(ms, k + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const float4* slot = ms.ring + (k % kStages) * ms.sets * kSetRows * kCh;
    const int c0 = k * kCh;
    const int cols = min(kCh, ms.nv4 - c0);
#pragma unroll
    for (int jj = 0; jj < kCh / kQuads; ++jj) {
      const int j = jj * kQuads + q;
      if (j < cols) {
        float4 v[kLive];
#pragma unroll
        for (int c = 0; c < kLive; ++c) v[c] = in4[c * ns4 + c0 + j];
#pragma unroll
        for (int m = 0; m < kMaxSets; ++m) {
          if (m < ms.sets) {
            const float4 mv = slot[swizzle(m * kSetRows + rr, j)];
#pragma unroll
            for (int c = 0; c < kLive; ++c) {
              acc[m][c] = __fmaf_rn(mv.x, v[c].x, acc[m][c]);
              acc[m][c] = __fmaf_rn(mv.y, v[c].y, acc[m][c]);
              acc[m][c] = __fmaf_rn(mv.z, v[c].z, acc[m][c]);
              acc[m][c] = __fmaf_rn(mv.w, v[c].w, acc[m][c]);
            }
          }
        }
      }
    }
    __syncwarp();
  }
  for (int k = 0; k < kStages - 1; ++k) issue_chunk(ms, k);
#pragma unroll
  for (int m = 0; m < kMaxSets; ++m) {
#pragma unroll
    for (int c = 0; c < kLive; ++c) {
      float t = acc[m][c];
      t += __shfl_xor_sync(kFull, t, 1);
      t += __shfl_xor_sync(kFull, t, 2);
      acc[m][c] = t;
    }
    const int row = (ms.set0 + kWarps * m) * kSetRows + rr;
    if (q == 0 && m < ms.sets && row < ms.n) {
#pragma unroll
      for (int c = 0; c < kLive; ++c) {
        float* o = out + c * ns + row;
        *o = kAdd ? *o + acc[m][c] : acc[m][c];
      }
    }
  }
  if (!kAdd) {
    for (int c = 0; c < kLive; ++c)
      for (int r = ms.n + threadIdx.x; r < ns; r += kThreads)
        out[c * ns + r] = 0.0f;
  }
  __syncthreads();
  pc.lap(kMinvApply);
}

// Per-block views of one scenario's inputs and iterates.
struct Scenario {
  const float *q, *hs, *x0;                // (8, n_pad)
  const float* d;                          // (kLive, ns) in shared memory
  Csr A, T;                                // A_ext and A_ext^T, shared memory
  const float *el, *rl, *irl, *lol, *hil;  // (8, lin_pad)
  const float4* rec;                       // (6, W, K, 2)
  unsigned long long pol;                  // L2 policy of the record stream
  float *zo, *yo;                          // (6, W, K) in device memory
};

// One a_s pass on v (kLive vectors at stride ns): sE = A_ext (d * v), then
// turned in place into the A^T input by the linear and obstacle rows.
// First every thread takes rows of A_ext, all candidates at once. Then a
// group of 8 lanes owns one (candidate, step) obstacle row: it reads the
// row's five copy values, walks its K slots kBatch at a time (the records
// of a batch loaded before any is used) and writes the five A^T sums; and
// every thread takes linear rows, all candidates at once.
template <Pass kPass>
__device__ void rows_pass(const FleetArgs& a, const Scenario& sc, int ns,
                          const float* v, float* sE, float* sZl, float* sYl,
                          PhaseClock& pc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l8 = lane & (kGroup - 1);
  const int W = a.W, K = a.K, Wp = a.Wp, lp = a.lin_pad, n_ext = a.n_ext;
  for (int r = threadIdx.x; r < n_ext; r += kThreads) {
    float e[kLive];
    gather_dv(sc.A, r, sc.d, v, ns, e);
#pragma unroll
    for (int c = 0; c < kLive; ++c) sE[c * n_ext + r] = e[c];
  }
  __syncthreads();
  pc.lap(kCsrA);

  const int items = kLive * W;
  // the trip count is uniform over the warp, so the shuffles see all lanes
  for (int base = warp * kRowsPerWarp; base < items;
       base += kWarps * kRowsPerWarp) {
    const int item = base + lane / kGroup;
    const bool live = item < items;
    const int c = live ? item / W : 0;
    const int w = item - c * W;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f, c3 = 0.0f, c4 = 0.0f;
    float* e = sE + c * n_ext + lp + w;
    if (live) {
      const float px = e[0], py = e[Wp], pz = e[2 * Wp];
      const float u3 = e[3 * Wp], u4 = e[4 * Wp];
      const float4* rec = sc.rec + (size_t)item * K * 2;
      float* zrow = sc.zo + item * K;
      float* yrow = sc.yo + item * K;
      for (int k0 = l8; k0 < K; k0 += kGroup * kBatch) {
        float4 g0[kBatch], g1[kBatch];
        float zb[kBatch], yb[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int k = k0 + b * kGroup;
          if (k < K) {
            g0[b] = ldg_stream(rec + 2 * k, sc.pol);
            g1[b] = ldg_stream(rec + 2 * k + 1, sc.pol);
            if (kPass == kUpdate) {
              zb[b] = zrow[k];
              yb[b] = yrow[k];
            }
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int k = k0 + b * kGroup;
          if (k < K) {
            const float gx = g0[b].x, gy = g0[b].y, gz = g0[b].z;
            const float s3 = g0[b].w, s4 = g1[b].x, ro = g1[b].y;
            const float zt = gx * px + gy * py + gz * pz + s3 * u3 + s4 * u4;
            float wo;
            if (kPass == kInit) {
              zrow[k] = zt;
              yrow[k] = 0.0f;
              wo = ro * zt - 0.0f;
            } else if (kPass == kMApply) {
              wo = ro * zt;
            } else {
              const float zr = a.alpha * zt + a.beta * zb[b];
              const float zn = max_keep_nan(zr + yb[b] * g1[b].z, g1[b].w);
              const float yn = yb[b] + ro * (zr - zn);
              zrow[k] = zn;
              yrow[k] = yn;
              wo = ro * zn - yn;
            }
            cx += wo * gx;
            cy += wo * gy;
            cz += wo * gz;
            c3 += wo * s3;
            c4 += wo * s4;
          }
        }
      }
    }
    cx = group_sum(cx);
    cy = group_sum(cy);
    cz = group_sum(cz);
    c3 = group_sum(c3);
    c4 = group_sum(c4);
    if (live && l8 == 0) {
      e[0] = cx;
      e[Wp] = cy;
      e[2 * Wp] = cz;
      e[3 * Wp] = c3;
      e[4 * Wp] = c4;
    }
  }
  if (pc.out) {  // the two row kinds share a phase unless they are timed
    __syncthreads();
    pc.lap(kObsRows);
  }
  for (int r = threadIdx.x; r < lp; r += kThreads) {
#pragma unroll
    for (int c = 0; c < kLive; ++c) {
      const int i = c * lp + r;
      float* e = sE + c * n_ext + r;
      const float el = sc.el[i];
      const float rl = sc.rl[i];
      if (kPass == kInit) {
        const float z = el * *e;
        sZl[i] = z;
        sYl[i] = 0.0f;
        *e = el * (rl * z - 0.0f);
      } else if (kPass == kMApply) {
        *e = el * (rl * (el * *e));
      } else {
        const float zt = el * *e;
        const float z = sZl[i];
        const float y = sYl[i];
        const float zr = a.alpha * zt + a.beta * z;
        const float zn = clip_keep_nan(zr + y * sc.irl[i], sc.lol[i], sc.hil[i]);
        const float yn = y + rl * (zr - zn);
        sZl[i] = zn;
        sYl[i] = yn;
        *e = el * (rl * zn - yn);
      }
    }
  }
  __syncthreads();
  pc.lap(pc.out ? kLinRows : kObsRows);
}

__global__ void __launch_bounds__(kThreads, 1)
fleet_admm_kernel(const FleetArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ long long clk_acc[kPhases + 1];
  const Plan pl = plan(a);
  const int ns = pl.ns, n_pad = a.n_pad, lp = a.lin_pad;
  const int warp = threadIdx.x >> 5;
  float4* ring = smem4;                                  // Minv chunks
  float* sX = reinterpret_cast<float*>(ring + pl.ring);  // x  (kLive, ns)
  float* sXt = sX + kLive * ns;                          // x-tilde
  float* sRhs = sXt + kLive * ns;                        // rhs
  float* sT = sRhs + kLive * ns;                         // residual
  float* sD = sT + kLive * ns;                           // d
  float* sE = sD + kLive * ns;                           // A_ext image (kLive, n_ext)
  float* sZl = sE + kLive * a.n_ext;                     // z, linear (kLive, lin_pad)
  float* sYl = sZl + kLive * lp;                         // y, linear
  int* sAptr = reinterpret_cast<int*>(sYl + kLive * lp);  // A_ext CSR
  int* sAcol = sAptr + a.n_ext + 1;
  float* sAval = reinterpret_cast<float*>(sAcol + a.nnz);
  int* sTptr = reinterpret_cast<int*>(sAval + a.nnz);    // A_ext^T CSR, rows < ns
  int* sTcol = sTptr + ns + 1;
  float* sTval = reinterpret_cast<float*>(sTcol + a.nnz);

  const int s = blockIdx.x;
  const size_t vn = (size_t)s * kLanes * n_pad;
  const size_t vl = (size_t)s * kLanes * lp;
  const int no = a.W * a.K;
  Scenario sc;
  sc.d = sD;
  sc.A = Csr{sAptr, sAcol, sAval};
  sc.T = Csr{sTptr, sTcol, sTval};
  sc.q = a.q + vn;
  sc.hs = a.hs + vn;
  sc.x0 = a.x0 + vn;
  sc.el = a.el + vl;
  sc.rl = a.rl + vl;
  sc.irl = a.irl + vl;
  sc.lol = a.lol + vl;
  sc.hil = a.hil + vl;
  sc.rec = a.rec + (size_t)s * kLive * no * 2;
  sc.pol = stream_policy();
  float* yo_out = a.yo_out + (size_t)s * kLanes * no;
  sc.zo = a.zo + (size_t)s * kLive * no;
  sc.yo = yo_out;

  MinvStream ms;
  {
    const int full = pl.nsets / kWarps, extra = pl.nsets % kWarps;
    const int before = warp * full + min(warp, extra);  // sets of warps < warp
    ms.m = a.minv + (size_t)s * n_pad * n_pad;
    ms.pol = sc.pol;
    ms.sets = full + (warp < extra ? 1 : 0);
    ms.ring = ring + (size_t)before * kStages * kSetRows * kCh;
    ms.n = a.n;
    ms.n_pad = n_pad;
    ms.set0 = warp;
    ms.nv4 = ns >> 2;
    ms.nchunks = (ms.nv4 + kCh - 1) / kCh;
  }
  for (int k = 0; k < kStages - 1; ++k) issue_chunk(ms, k);

  PhaseClock pc(a.clk, clk_acc);
  for (int c = 0; c < kLive; ++c)
    for (int r = threadIdx.x; r < ns; r += kThreads) {
      sX[c * ns + r] = sc.x0[c * n_pad + r];
      sD[c * ns + r] = a.d[vn + c * n_pad + r];
    }
  for (int i = threadIdx.x; i <= a.n_ext; i += kThreads) sAptr[i] = a.a_ptr[i];
  for (int i = threadIdx.x; i <= ns; i += kThreads) sTptr[i] = a.at_ptr[i];
  for (int i = threadIdx.x; i < a.nnz; i += kThreads) {
    sAcol[i] = a.a_col[i];
    sAval[i] = a.a_val[i];
    sTcol[i] = a.at_col[i];
    sTval[i] = a.at_val[i];
  }
  __syncthreads();
  pc.lap(kVecUpdate);
  rows_pass<kInit>(a, sc, ns, sX, sE, sZl, sYl, pc);

  for (int it = 0; it < a.iters; ++it) {
    // x = alpha xt + beta x (from the previous iteration), then
    // rhs = sigma x - q + d * A^T(w); sE holds w from the previous pass
    for (int r = threadIdx.x; r < ns; r += kThreads) {
      float at[kLive];
      gather_t(sc.T, r, sE, a.n_ext, at);
#pragma unroll
      for (int c = 0; c < kLive; ++c) {
        const int i = c * ns + r;
        float x = sX[i];
        if (it > 0) {
          x = a.alpha * sXt[i] + a.beta * x;
          sX[i] = x;
        }
        sRhs[i] = a.sigma * x - sc.q[c * n_pad + r] + sc.d[i] * at[c];
      }
    }
    __syncthreads();
    pc.lap(kCsrAt);
    minv_apply<false>(ms, ns, sRhs, sXt, pc);
    for (int rf = 0; rf < a.refine; ++rf) {
      // residual rhs - (hs xt + at_s(rho a_s(xt))), then xt += Minv residual
      rows_pass<kMApply>(a, sc, ns, sXt, sE, sZl, sYl, pc);
      for (int r = threadIdx.x; r < ns; r += kThreads) {
        float at[kLive];
        gather_t(sc.T, r, sE, a.n_ext, at);
#pragma unroll
        for (int c = 0; c < kLive; ++c) {
          const int i = c * ns + r;
          sT[i] = sRhs[i] - (sc.hs[c * n_pad + r] * sXt[i] + sc.d[i] * at[c]);
        }
      }
      __syncthreads();
      pc.lap(kCsrAt);
      minv_apply<true>(ms, ns, sT, sXt, pc);
    }
    // z/y update from a_s(xt); the x blend rides the next rhs
    rows_pass<kUpdate>(a, sc, ns, sXt, sE, sZl, sYl, pc);
  }

  float* x_out = a.x_out + vn;
  float* yl_out = a.yl_out + vl;
  for (int c = 0; c < kLanes; ++c)
    for (int r = threadIdx.x; r < n_pad; r += kThreads) {
      float x = 0.0f;
      if (c < kLive && r < ns) {
        const int i = c * ns + r;
        x = a.iters > 0 ? a.alpha * sXt[i] + a.beta * sX[i] : sX[i];
      }
      x_out[c * n_pad + r] = x;
    }
  for (int i = threadIdx.x; i < kLanes * lp; i += kThreads)
    yl_out[i] = i < kLive * lp ? sYl[i] : 0.0f;
  for (int i = kLive * no + threadIdx.x; i < kLanes * no; i += kThreads)
    yo_out[i] = 0.0f;
  cp_async_wait<0>();   // the last apply's look-ahead chunks
  __syncthreads();
  pc.lap(kVecUpdate);
  pc.store();
}

}  // namespace

extern "C" int fleet_admm_args_size() { return (int)sizeof(FleetArgs); }
extern "C" int fleet_admm_phases() { return kPhases; }

// The kernel's registers per thread and local (spill) bytes per thread,
// as the compiler built it; returns the cudaError_t of the query.
extern "C" int fleet_admm_resources(int* regs, int* local_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, fleet_admm_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = f.numRegs;
  *local_bytes = (int)f.localSizeBytes;
  return 0;
}

// args: host pointer to a FleetArgs; stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success). The wrapper
// (intent_mpc_torch/ops/fleet.py) checks shapes; n_pad must be a multiple
// of 4 for the float4 rows, n at most 512, K a multiple of 8.
extern "C" int fleet_admm_launch(const void* args, void* stream) {
  const FleetArgs& a = *static_cast<const FleetArgs*>(args);
  if (a.n_pad % 4 != 0 || a.n > a.n_pad
      || a.n > kWarps * kMaxSets * kSetRows || a.K % kGroup != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(a);
  if (p.bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fleet_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  if (a.S == 0) return 0;
  fleet_admm_kernel<<<a.S, kThreads, p.bytes,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
