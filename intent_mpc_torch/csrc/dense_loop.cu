// Dense-A ADMM loop: every iteration of one candidate QP per thread block,
// on its materialized, Ruiz-scaled constraint matrix (sm_90a).
//
// Replaces the TPU kernel intent_mpc_tpu/ops/pallas_admm.py::_kernel
// (:70-116, launched by admm_iterations_dense :119-153). Per candidate
// (inputs from intent_mpc_torch/ops/admm.py::_dense_scaled_problem):
//
//   x = x0; z = A x; y = 0; then `iters` times:
//     rhs = sigma x - q + A^T (rho z - y)
//     xt  = Minv rhs;  `refine` times: xt += Minv (rhs - M xt)
//     zt  = A xt;  x = alpha xt + (1 - alpha) x;  zr = alpha zt + (1 - alpha) z
//     z   = clip(zr + y / rho, lo, hi);  y = y + rho (zr - z)
//   and returns the scaled x (C, n_pad).
//
// Bound. The TPU kernel pins A, Minv and M in VMEM for the whole loop; a
// block has 227 KB of shared memory, against one candidate's dense A of
// 5.24 MB (2560 x 512 float32) and Minv of 1 MiB. But A is 99% zeros (the
// linear rows have at most 4 nonzeros, an obstacle row at most 5): each
// input read once is 4.86 GB at 768 candidates (1.45 ms at 3.35 TB/s),
// against 44.9 GFLOP of the work these inputs need (0.67 ms at 67
// TFLOP/s): bytes. What this design streams is A once and Minv (and M)
// once per apply: 84.6 GB per 100-iteration solve at refine 0, 25.2 ms at
// HBM's rate. Holding Minv on chip is left for later.
//
// Design. One 512-thread block runs one candidate's whole loop
// (candidates are independent: no grid-wide synchronisation, one launch
// per solve), one block per SM.
//  * Prologue: the block reads its dense A once, coalesced (a warp takes 2
//    rows of each batch of 32, a lane 4 float4 of a row), and compacts
//    each row's nonzeros into CSR in shared memory: float values, uint16
//    columns and row pointers, in row order and ascending column within a
//    row, placed by warp prefix counts of each lane's nonzeros and a
//    block scan of the row lengths: deterministic, no atomics. It also
//    keeps each nonzero's row and builds the column lists of A^T (indices
//    into the CSR, rows ascending) with one thread per column counting
//    and then placing its own entries. A is not read again.
//  * A candidate with more nonzeros than the CSR can hold writes its count
//    to `status` and NaN to its x and stops; the wrapper asserts on the
//    device that every status is 0. It never falls back to dense rows.
//  * zt = A xt: one thread per row walks its CSR row against xt in shared
//    memory and updates that row's z and y at once. A^T (rho z - y): one
//    thread per column walks its column list, recomputing each row's
//    rho z - y from z and y; it carries the x blend and the next rhs.
//  * Minv (and M) stream through shared memory: warp w owns rows w, w + 16,
//    ... and streams them with cp.async through its own ring of kStages
//    half rows (1 KB), kStages - 1 of them in flight; a lane copies, and
//    later reads, only its own 16-byte pieces, so the ring needs no
//    barrier. The next apply's first half rows are issued at the end of
//    each apply and load during the row and column passes. The stream is
//    marked L2 evict-first.
//  Shared memory: the ring (64 KB), x, x-tilde, rhs, the refinement
//  residual and q (n_pad each), z, y and rho (m_pad each; lo and hi are
//  read from L2), the CSR and the A^T lists (10 bytes per nonzero). At
//  n_pad 512 and m_pad 2560 that leaves room for 11,872 nonzeros; the
//  DYNUS A has at most 10,543 (ops/qp.py::dense_a_nnz_max).
//
// Precision: IEEE float32 on the CUDA cores, explicit __fmaf_rn in the dot
// products (the library is built with -fmad=false, so nothing else is
// contracted), the elementwise updates in the plain version's order,
// 1 - alpha rounded once on the host, the clip by two comparisons so that
// NaN stays NaN. No TF32: the rho_eq = 1e3 rows amplify a cheaper product's
// noise into divergence (pallas_admm.py:23-31). Every sum has a fixed
// order (a row's columns ascending; a column's rows ascending; a Minv row
// by a lane's columns in turn, then the shuffle butterfly) and there are
// no atomics, so the kernel is deterministic. The CSR skips A's zeros, so
// a NaN or inf in x-tilde no longer spreads along them as in the dense
// product; the next dense Minv apply still spreads it over the candidate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;                    // float4 columns per lane of a row
constexpr int kMaxN = 32 * 4 * kChunks;       // n_pad <= 512
constexpr int kHalf4 = 64;                    // float4 per ring item: half a row
constexpr int kStages = 4;                    // ring items per warp
constexpr int kMinN = 4 * kWarps;             // every warp streams >= 4 rows
constexpr int kRowsPerWarp = 2;               // rows per warp and prologue batch
constexpr int kBatchRows = kWarps * kRowsPerWarp;
constexpr size_t kRingBytes = (size_t)kWarps * kStages * kHalf4 * 16;
// shared memory a block can use, less this kernel's static arrays
constexpr size_t kSmemLimit = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMaxN == kThreads, "one thread per column of A^T");
constexpr int kLaneRows = kBatchRows / 32;     // rows per lane of the batch scan
static_assert(kBatchRows % 32 == 0, "the batch scan gives each lane whole rows");

struct DenseArgs {
  const float* minv;    // (C, n_pad, n_pad)
  const float* mmat;    // (C, n_pad, n_pad)
  const float* amat;    // (C, m_pad, n_pad)
  const float* q;       // (C, n_pad)
  const float* x0;      // (C, n_pad)
  const float* rho;     // (C, m_pad)
  const float* lo;
  const float* hi;
  float* x_out;         // (C, n_pad)
  int* status;          // (C,): 0, or the nonzeros of a candidate that did not fit
  int C, n_pad, m_pad, iters, refine;
  float sigma, alpha, beta;  // beta = 1 - alpha, rounded to float on the host
};

__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }

// The shared-memory plan; the kernel, the launcher and
// ops/dense_loop.py::csr_capacity compute it alike. cap: the nonzeros the
// CSR can hold (a multiple of 8), 0 when the rest does not fit.
struct Plan {
  int ms;        // z, y, rho stride: m_pad rounded up to 4
  int cap;
  size_t bytes;
};

__host__ __device__ inline Plan plan(int n_pad, int m_pad) {
  Plan p;
  p.ms = (m_pad + 3) & ~3;
  const size_t fixed = kRingBytes + 4 * (5 * (size_t)n_pad + 3 * (size_t)p.ms)
                       + 2 * (size_t)(round8(m_pad + 1) + round8(n_pad + 1));
  const long long left = (long long)kSmemLimit - (long long)fixed;
  p.cap = left < 80 ? 0 : (int)((left / 10) & ~7LL);
  p.bytes = fixed + 10 * (size_t)p.cap;
  return p;
}

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  const float t = v < lo ? lo : v;
  return t > hi ? hi : t;
}

// The sum over the warp; the butterfly gives every lane the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// Lane `lane` owns columns 128 c + 4 lane .. + 3 of chunk c.
__device__ __forceinline__ bool chunk_ok(int c, int lane, int n_pad) {
  return c * 128 + 4 * lane < n_pad;
}

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One warp's stream of its rows of an (n_pad x n_pad) matrix: rows warp,
// warp + kWarps, ...; item t is half h = t % nh of the warp's row t / nh.
// Items go into the ring in the order they are used, so item k of the
// warp's whole stream sits in slot k % kStages.
struct Ring {
  float4* slots;     // this warp's kStages items
  unsigned long long pol;
  int issued, used;  // items since the start
  int items;         // items per apply: rows x nh
  int nh;            // items per row: 1 or 2
  int n_pad, nv4;
};

// Issue item t of an apply over `mat` and commit one cp.async group.
__device__ __forceinline__ void issue(Ring& r, const float* mat, int t) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = warp + kWarps * (t / r.nh);
  const int h = t % r.nh;
  float4* slot = r.slots + (r.issued % kStages) * kHalf4;
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int f = 64 * h + 32 * cc + lane;
    if (f < r.nv4)
      cp_async16_stream(slot + 32 * cc + lane,
                        mat + (size_t)row * r.n_pad + 4 * f, r.pol);
  }
  ++r.issued;
  cp_async_commit();
}

enum MatvecMode {
  kSet,   // out = m v
  kSub,   // out = base - m v
  kAdd,   // out = out + m v
};

// One (n_pad x n_pad) product with a shared-memory vector, a warp per row,
// the rows streamed through the warp's ring. Expects items 0 .. kStages-2
// of `mat` issued; issues them of `next` (the matrix of the next apply)
// as its own run out. A lane sums its columns in chunk order, then the
// warp's butterfly adds the lanes.
template <MatvecMode kMode>
__device__ void apply(Ring& r, const float* __restrict__ mat,
                      const float* __restrict__ next, const float* v,
                      const float* base, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_pad = r.n_pad;
  float4 vs[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    vs[c] = chunk_ok(c, lane, n_pad)
                ? reinterpret_cast<const float4*>(v)[c * 32 + lane]
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int rows = r.items / r.nh;
  for (int k = 0; k < rows; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h < r.nh) {
        const int u = k * r.nh + h + kStages - 1;
        if (u < r.items) issue(r, mat, u);
        else issue(r, next, u - r.items);
        cp_async_wait<kStages - 1>();
        const float4* slot = r.slots + (r.used % kStages) * kHalf4;
        ++r.used;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = 2 * h + cc;
          if (chunk_ok(c, lane, n_pad)) {
            const float4 a = slot[32 * cc + lane];
            acc = __fmaf_rn(a.x, vs[c].x, acc);
            acc = __fmaf_rn(a.y, vs[c].y, acc);
            acc = __fmaf_rn(a.z, vs[c].z, acc);
            acc = __fmaf_rn(a.w, vs[c].w, acc);
          }
        }
      }
    }
    const float s = warp_sum(acc);
    if (lane == 0) {
      const int i = warp + kWarps * k;
      if (kMode == kSet) out[i] = s;
      else if (kMode == kSub) out[i] = base[i] - s;
      else out[i] = out[i] + s;
    }
  }
  __syncthreads();
}

// Shared-memory views of one block.
struct Block {
  float *x, *xt, *rhs, *r, *q;   // (n_pad)
  float *z, *y, *rho;            // (m_pad)
  float* val;                    // CSR of A: values, columns, rows
  unsigned short *col, *arow;
  unsigned short* tp;            // A^T lists: CSR indices, by column
  unsigned short *row_ptr, *col_ptr;
};

// zt = A v row by row; each row's z/y update (kInit: z = zt, y = 0).
template <bool kInit>
__device__ void row_pass(const DenseArgs& p, const Block& b, const float* v,
                         const float* __restrict__ lo,
                         const float* __restrict__ hi) {
  for (int i = threadIdx.x; i < p.m_pad; i += kThreads) {
    const int e = b.row_ptr[i + 1];
    float zt = 0.0f;
    for (int k = b.row_ptr[i]; k < e; ++k)
      zt = __fmaf_rn(b.val[k], v[b.col[k]], zt);
    if (kInit) {
      b.z[i] = zt;
      b.y[i] = 0.0f;
    } else {
      const float r = b.rho[i];
      const float z = b.z[i];
      const float y = b.y[i];
      const float zr = p.alpha * zt + p.beta * z;
      const float zn = clip_keep_nan(zr + y / r, __ldg(lo + i), __ldg(hi + i));
      b.z[i] = zn;
      b.y[i] = y + r * (zr - zn);
    }
  }
  __syncthreads();
}

// A^T w, w = rho z - y, a column at a time, then (kBlend) x = alpha xt +
// (1 - alpha) x, and the next rhs = sigma x - q + A^T w.
template <bool kBlend>
__device__ void col_pass(const DenseArgs& p, const Block& b) {
  const int j = threadIdx.x;
  if (j < p.n_pad) {
    const int e = b.col_ptr[j + 1];
    float atw = 0.0f;
#pragma unroll 4
    for (int k = b.col_ptr[j]; k < e; ++k) {
      const int t = b.tp[k];
      const int i = b.arow[t];
      const float w = b.rho[i] * b.z[i] - b.y[i];
      atw = __fmaf_rn(b.val[t], w, atw);
    }
    float x = b.x[j];
    if (kBlend) {
      x = p.alpha * b.xt[j] + p.beta * x;
      b.x[j] = x;
    }
    b.rhs[j] = p.sigma * x - b.q[j] + atw;
  }
  __syncthreads();
}

// Block-wide exclusive scan of one int per thread, in thread order.
__device__ int block_excl_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_incl_scan(v, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kWarps ? s_warp[lane] : 0;
    const int ti = warp_incl_scan(t, lane);
    __syncwarp();
    if (lane < kWarps) s_warp[lane] = ti - t;
  }
  __syncthreads();
  const int out = s_warp[warp] + incl - v;
  __syncthreads();
  return out;
}

// 1 where a 16-bit half of w equals j, summed over the halves of a uint4.
__device__ __forceinline__ int count_eq(uint4 w, unsigned jj) {
  return (__popc(__vcmpeq2(w.x, jj)) + __popc(__vcmpeq2(w.y, jj))
          + __popc(__vcmpeq2(w.z, jj)) + __popc(__vcmpeq2(w.w, jj))) >> 4;
}

// The CSR of the block's dense A (row pointers, values, columns and each
// entry's row), in row order, ascending columns. Returns the nonzeros; an
// entry past cap is not stored.
__device__ int compact(const DenseArgs& p, const float* __restrict__ A,
                       const Block& b, int cap, int* s_cnt, int* s_base) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_pad = p.n_pad, m_pad = p.m_pad;
  for (int r0 = 0; r0 < m_pad; r0 += kBatchRows) {
    float4 v[kRowsPerWarp][kChunks];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int row = r0 + warp * kRowsPerWarp + k;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        v[k][c] = row < m_pad && chunk_ok(c, lane, n_pad)
                      ? __ldcs(reinterpret_cast<const float4*>(
                                   A + (size_t)row * n_pad) + c * 32 + lane)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    // each lane's first position within its row, per chunk
    int off[kRowsPerWarp][kChunks];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      int run = 0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int cnt = (v[k][c].x != 0.0f) + (v[k][c].y != 0.0f)
                        + (v[k][c].z != 0.0f) + (v[k][c].w != 0.0f);
        const int incl = warp_incl_scan(cnt, lane);
        off[k][c] = run + incl - cnt;
        run += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) s_cnt[warp * kRowsPerWarp + k] = run;
    }
    __syncthreads();
    if (warp == 0) {   // row pointers of the batch: kLaneRows rows per lane
      int len[kLaneRows], sum = 0;
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) {
        len[k] = s_cnt[kLaneRows * lane + k];
        sum += len[k];
      }
      const int incl = warp_incl_scan(sum, lane);
      const int base = *s_base;
      __syncwarp();
      int first = base + incl - sum;
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) {
        const int row = r0 + kLaneRows * lane + k;
        if (row < m_pad) b.row_ptr[row] = (unsigned short)first;
        first += len[k];
      }
      if (lane == 31) *s_base = base + incl;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int row = r0 + warp * kRowsPerWarp + k;
      if (row < m_pad) {
        const int start = b.row_ptr[row];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          int t = start + off[k][c];
          const float e[4] = {v[k][c].x, v[k][c].y, v[k][c].z, v[k][c].w};
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            if (e[d] != 0.0f) {
              if (t < cap) {
                b.val[t] = e[d];
                b.col[t] = (unsigned short)(c * 128 + 4 * lane + d);
                b.arow[t] = (unsigned short)row;
              }
              ++t;
            }
          }
        }
      }
    }
  }
  __syncthreads();
  return *s_base;
}

__global__ void __launch_bounds__(kThreads, 1)
dense_loop_kernel(const DenseArgs p) {
  extern __shared__ float4 smem4[];
  __shared__ int s_cnt[kBatchRows];
  __shared__ int s_warp[kWarps];
  __shared__ int s_base;
  const int n_pad = p.n_pad, m_pad = p.m_pad;
  const Plan pl = plan(n_pad, m_pad);
  const int cap = pl.cap;
  const int warp = threadIdx.x >> 5;
  float4* ring = smem4;
  Block b;
  b.x = reinterpret_cast<float*>(ring + kRingBytes / 16);
  b.xt = b.x + n_pad;
  b.rhs = b.xt + n_pad;
  b.r = b.rhs + n_pad;
  b.q = b.r + n_pad;
  b.z = b.q + n_pad;
  b.y = b.z + pl.ms;
  b.rho = b.y + pl.ms;
  b.val = b.rho + pl.ms;
  b.col = reinterpret_cast<unsigned short*>(b.val + cap);
  b.arow = b.col + cap;
  b.tp = b.arow + cap;
  b.row_ptr = b.tp + cap;
  b.col_ptr = b.row_ptr + round8(m_pad + 1);

  const size_t c = blockIdx.x;
  const float* A = p.amat + c * m_pad * n_pad;
  const float* minv = p.minv + c * n_pad * n_pad;
  const float* mmat = p.mmat + c * n_pad * n_pad;
  const float* lo = p.lo + c * m_pad;
  const float* hi = p.hi + c * m_pad;

  Ring ring_w;
  ring_w.slots = ring + (size_t)warp * kStages * kHalf4;
  ring_w.pol = stream_policy();
  ring_w.issued = ring_w.used = 0;
  ring_w.nh = (n_pad + 255) / 256;
  ring_w.items = ((n_pad - warp + kWarps - 1) / kWarps) * ring_w.nh;
  ring_w.n_pad = n_pad;
  ring_w.nv4 = n_pad / 4;
  for (int k = 0; k < kStages - 1; ++k) issue(ring_w, minv, k);

  for (int j = threadIdx.x; j < n_pad; j += kThreads) {
    b.x[j] = p.x0[c * n_pad + j];
    b.q[j] = p.q[c * n_pad + j];
  }
  for (int i = threadIdx.x; i < m_pad; i += kThreads)
    b.rho[i] = p.rho[c * m_pad + i];
  if (threadIdx.x == 0) s_base = 0;
  __syncthreads();

  const int nnz = compact(p, A, b, cap, s_cnt, &s_base);
  if (nnz > cap) {   // block-uniform: the candidate does not fit
    if (threadIdx.x == 0) p.status[c] = nnz;
    for (int j = threadIdx.x; j < n_pad; j += kThreads)
      p.x_out[c * n_pad + j] = __int_as_float(0x7fc00000);
    cp_async_wait<0>();
    return;
  }
  if (threadIdx.x == 0) {
    p.status[c] = 0;
    b.row_ptr[m_pad] = (unsigned short)nnz;
  }
  // the column lists of A^T: thread j counts, then places, its entries;
  // the column array's tail up to a multiple of 8 matches no column
  for (int t = nnz + threadIdx.x; t < round8(nnz); t += kThreads)
    b.col[t] = 0xffff;
  __syncthreads();
  const int j = threadIdx.x;
  const unsigned jj = (unsigned)j * 0x10001u;
  const uint4* col4 = reinterpret_cast<const uint4*>(b.col);
  const int words = round8(nnz) / 8;
  int cnt = 0;
  if (j < n_pad)
    for (int w = 0; w < words; ++w) cnt += count_eq(col4[w], jj);
  const int first = block_excl_scan(cnt, s_warp);
  if (j < n_pad) {
    b.col_ptr[j] = (unsigned short)first;
    int t = first;
    for (int w = 0; w < words; ++w) {
      const uint4 q4 = col4[w];
      if (count_eq(q4, jj)) {
        const unsigned short* q = b.col + 8 * w;
#pragma unroll
        for (int d = 0; d < 8; ++d)
          if (q[d] == j) b.tp[t++] = (unsigned short)(8 * w + d);
      }
    }
  }
  if (threadIdx.x == 0) b.col_ptr[n_pad] = (unsigned short)nnz;
  __syncthreads();

  row_pass<true>(p, b, b.x, lo, hi);
  col_pass<false>(p, b);
  for (int it = 0; it < p.iters; ++it) {
    apply<kSet>(ring_w, minv, p.refine > 0 ? mmat : minv, b.rhs, nullptr,
                b.xt);
    for (int k = 0; k < p.refine; ++k) {
      apply<kSub>(ring_w, mmat, minv, b.xt, b.rhs, b.r);
      apply<kAdd>(ring_w, minv, k + 1 < p.refine ? mmat : minv, b.r, nullptr,
                  b.xt);
    }
    row_pass<false>(p, b, b.xt, lo, hi);
    col_pass<true>(p, b);
  }
  for (int j2 = threadIdx.x; j2 < n_pad; j2 += kThreads)
    p.x_out[c * n_pad + j2] = b.x[j2];
  cp_async_wait<0>();   // the last apply's look-ahead
}

}  // namespace

extern "C" int dense_loop_args_size() { return (int)sizeof(DenseArgs); }

// The nonzeros per candidate the kernel's CSR holds at these shapes (0 when
// the rest of its shared memory does not fit).
extern "C" int dense_loop_csr_capacity(int n_pad, int m_pad) {
  return plan(n_pad, m_pad).cap;
}

// The kernel's registers per thread and local (spill) bytes per thread,
// as the compiler built it; returns the cudaError_t of the query.
extern "C" int dense_loop_resources(int* regs, int* local_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, dense_loop_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = f.numRegs;
  *local_bytes = (int)f.localSizeBytes;
  return 0;
}

// args: host pointer to a DenseArgs; stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// shapes the kernel does not take (n_pad not a multiple of 4, or outside
// [kMinN, kMaxN]; vectors and ring beyond one block's shared memory); the
// wrapper (intent_mpc_torch/ops/dense_loop.py) raises on it. This is the
// one place where the kernel's shape limits are checked.
extern "C" int dense_loop_launch(const void* args, void* stream) {
  const DenseArgs& a = *static_cast<const DenseArgs*>(args);
  if (a.n_pad < kMinN || a.n_pad % 4 != 0 || a.n_pad > kMaxN || a.m_pad <= 0 ||
      a.iters < 0 || a.refine < 0 || a.C < 0)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan(a.n_pad, a.m_pad);
  if (pl.cap <= 0 || pl.bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dense_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.bytes);
  if (err != cudaSuccess) return (int)err;
  if (a.C == 0) return 0;
  dense_loop_kernel<<<a.C, kThreads, pl.bytes,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
