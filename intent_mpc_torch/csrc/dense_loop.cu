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
// Design. The TPU kernel pins A, Minv and M in VMEM for the whole loop. On
// the card one candidate's A is 5.24 MB (2560 x 512 float32) and Minv and M
// 1 MiB each, against 227 KB of shared memory per block, so they stream from
// L2/HBM on every product. One thread block runs one candidate's whole loop
// (candidates are independent: no grid-wide synchronisation, one launch per
// solve), with __syncthreads between phases. The block keeps its vectors in
// shared memory: x, x-tilde, rhs, the refinement residual and q (n_pad
// each), the warps' partial A^T sums (8 x n_pad), and z, y, rho, lo and hi
// (m_pad each): 76 KB at n_pad = 512, m_pad = 2560, so two blocks share an
// SM. Every matrix row is read by one warp as float4 loads (4 per lane at
// n_pad = 512) against the lane's slice of the vector, held in registers
// for the whole pass, and reduced with a shuffle butterfly.
//
// One pass over A per iteration: the pass that computes zt = A xt row by
// row updates that row's z and y at once, forms its w_i = rho_i z_i - y_i
// of the next iteration's A^T w, and adds w_i times the row (still in
// registers) to the warp's partial A^T sums. The 8 partials are summed in
// warp order afterwards. A is read once per iteration instead of twice,
// and there is no stored A^T.
//
// Bound. Each input is needed once: at 128 scenarios (768 candidates) and
// refine 0 that is 4.86 GB (1.45 ms at 3.35 TB/s), against 448 GFLOP of
// padded dense float32 work for 100 iterations (6.7 ms at 67 TFLOP/s):
// operations. The kernel is far from that bound: it streams A and Minv
// from memory on every iteration (6.3 MB per candidate and iteration at
// refine 0, 487 GB per 100-iteration solve at 768 candidates, 145 ms at
// HBM's rate), and that stream sets its time. A is mostly zeros (the
// obstacle rows have 4 nonzeros each); keeping it on chip as CSR is later
// work.
//
// Precision: IEEE float32 on the CUDA cores, explicit __fmaf_rn in the dot
// products (the library is built with -fmad=false, so nothing else is
// contracted), the elementwise updates in the plain version's order,
// 1 - alpha rounded once on the host, the clip by two comparisons so that
// NaN stays NaN. No TF32: the rho_eq = 1e3 rows amplify a cheaper product's
// noise into divergence (pallas_admm.py:23-31). Every sum has a fixed
// order (a lane's columns in turn, the shuffle butterfly, the warps in
// turn) and there are no atomics, so the kernel is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;                    // float4 columns per lane
constexpr int kMaxN = 32 * 4 * kChunks;       // n_pad <= 512
constexpr size_t kSmemLimit = 232448;         // 227 KB per block
constexpr unsigned kFull = 0xffffffffu;

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
  int C, n_pad, m_pad, iters, refine;
  float sigma, alpha, beta;  // beta = 1 - alpha, rounded to float on the host
};

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

// Lane `lane` owns columns 128 c + 4 lane .. + 3 of chunk c.
__device__ __forceinline__ bool chunk_ok(int c, int lane, int n_pad) {
  return c * 128 + 4 * lane < n_pad;
}

__device__ __forceinline__ void load_slice(const float* s, int lane, int n_pad,
                                           float4 (&v)[kChunks]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    v[c] = chunk_ok(c, lane, n_pad)
               ? reinterpret_cast<const float4*>(s)[c * 32 + lane]
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// row . v over the warp; the lane's part of the row is left in a.
__device__ __forceinline__ float row_dot(const float* __restrict__ row,
                                         const float4 (&v)[kChunks], int lane,
                                         int n_pad, float4 (&a)[kChunks]) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (chunk_ok(c, lane, n_pad)) {
      a[c] = __ldg(reinterpret_cast<const float4*>(row) + c * 32 + lane);
      acc = __fmaf_rn(a[c].x, v[c].x, acc);
      acc = __fmaf_rn(a[c].y, v[c].y, acc);
      acc = __fmaf_rn(a[c].z, v[c].z, acc);
      acc = __fmaf_rn(a[c].w, v[c].w, acc);
    }
  }
  return warp_sum(acc);
}

enum MatvecMode {
  kSet,   // out = m v
  kSub,   // out = base - m v
  kAdd,   // out = out + m v
};

// One (n_pad x n_pad) product with a shared-memory vector, a warp per row.
template <MatvecMode kMode>
__device__ void matvec(const float* __restrict__ m, int n_pad, const float* v,
                       const float* base, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4 vs[kChunks];
  load_slice(v, lane, n_pad, vs);
  for (int i = warp; i < n_pad; i += kWarps) {
    float4 a[kChunks];
    const float s = row_dot(m + (size_t)i * n_pad, vs, lane, n_pad, a);
    if (lane == 0) {
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
  float *part;                   // (kWarps, n_pad) partial A^T sums
  float *z, *y, *rho, *lo, *hi;  // (m_pad)
};

// zt = A v row by row; the z/y update of each row (kInit: z = zt, y = 0)
// and its w = rho z - y, accumulated as w times the row into the warp's
// partial A^T w.
template <bool kInit>
__device__ void a_pass(const DenseArgs& p, const float* __restrict__ A,
                       const float* v, const Block& b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_pad = p.n_pad;
  float4 vs[kChunks], acc[kChunks];
  load_slice(v, lane, n_pad, vs);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = warp; i < p.m_pad; i += kWarps) {
    float4 a[kChunks];
    const float zt = row_dot(A + (size_t)i * n_pad, vs, lane, n_pad, a);
    const float r = b.rho[i];
    float w;
    if (kInit) {
      w = r * zt - 0.0f;
      if (lane == 0) {
        b.z[i] = zt;
        b.y[i] = 0.0f;
      }
    } else {
      const float z = b.z[i];
      const float y = b.y[i];
      const float zr = p.alpha * zt + p.beta * z;
      const float zn = clip_keep_nan(zr + y / r, b.lo[i], b.hi[i]);
      const float yn = y + r * (zr - zn);
      w = r * zn - yn;
      __syncwarp();          // every lane has read z[i], y[i]
      if (lane == 0) {
        b.z[i] = zn;
        b.y[i] = yn;
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (chunk_ok(c, lane, n_pad)) {
        acc[c].x = __fmaf_rn(a[c].x, w, acc[c].x);
        acc[c].y = __fmaf_rn(a[c].y, w, acc[c].y);
        acc[c].z = __fmaf_rn(a[c].z, w, acc[c].z);
        acc[c].w = __fmaf_rn(a[c].w, w, acc[c].w);
      }
    }
  }
  float4* part = reinterpret_cast<float4*>(b.part + (size_t)warp * n_pad);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (chunk_ok(c, lane, n_pad)) part[c * 32 + lane] = acc[c];
  __syncthreads();
}

// A^T w from the partials, then (kBlend) x = alpha xt + (1 - alpha) x, and
// the next rhs = sigma x - q + A^T w.
template <bool kBlend>
__device__ void finish(const DenseArgs& p, const Block& b) {
  const int n_pad = p.n_pad;
  for (int j = threadIdx.x; j < n_pad; j += kThreads) {
    float atw = b.part[j];
    for (int w = 1; w < kWarps; ++w) atw += b.part[w * n_pad + j];
    float x = b.x[j];
    if (kBlend) {
      x = p.alpha * b.xt[j] + p.beta * x;
      b.x[j] = x;
    }
    b.rhs[j] = p.sigma * x - b.q[j] + atw;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
dense_loop_kernel(const DenseArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_pad = p.n_pad, m_pad = p.m_pad;
  Block b;
  b.x = smem;                 // n-vectors first: float4-aligned (n_pad % 4 == 0)
  b.xt = b.x + n_pad;
  b.rhs = b.xt + n_pad;
  b.r = b.rhs + n_pad;
  b.q = b.r + n_pad;
  b.part = b.q + n_pad;
  b.z = b.part + kWarps * n_pad;
  b.y = b.z + m_pad;
  b.rho = b.y + m_pad;
  b.lo = b.rho + m_pad;
  b.hi = b.lo + m_pad;

  const size_t c = blockIdx.x;
  const float* A = p.amat + c * m_pad * n_pad;
  const float* minv = p.minv + c * n_pad * n_pad;
  const float* mmat = p.mmat + c * n_pad * n_pad;
  for (int j = threadIdx.x; j < n_pad; j += kThreads) {
    b.x[j] = p.x0[c * n_pad + j];
    b.q[j] = p.q[c * n_pad + j];
  }
  for (int i = threadIdx.x; i < m_pad; i += kThreads) {
    b.rho[i] = p.rho[c * m_pad + i];
    b.lo[i] = p.lo[c * m_pad + i];
    b.hi[i] = p.hi[c * m_pad + i];
  }
  __syncthreads();

  a_pass<true>(p, A, b.x, b);
  finish<false>(p, b);
  for (int it = 0; it < p.iters; ++it) {
    matvec<kSet>(minv, n_pad, b.rhs, nullptr, b.xt);
    for (int k = 0; k < p.refine; ++k) {
      matvec<kSub>(mmat, n_pad, b.xt, b.rhs, b.r);
      matvec<kAdd>(minv, n_pad, b.r, nullptr, b.xt);
    }
    a_pass<false>(p, A, b.xt, b);
    finish<true>(p, b);
  }
  for (int j = threadIdx.x; j < n_pad; j += kThreads)
    p.x_out[c * n_pad + j] = b.x[j];
}

size_t smem_bytes(const DenseArgs& a) {
  return sizeof(float) * ((5 + kWarps) * (size_t)a.n_pad + 5 * (size_t)a.m_pad);
}

}  // namespace

extern "C" int dense_loop_args_size() { return (int)sizeof(DenseArgs); }

// args: host pointer to a DenseArgs; stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// shapes the kernel does not take (n_pad not a multiple of 4 or above 512,
// vectors beyond one block's shared memory); the wrapper
// (intent_mpc_torch/ops/dense_loop.py) raises on it. This is the one
// place where the kernel's shape limits are checked.
extern "C" int dense_loop_launch(const void* args, void* stream) {
  const DenseArgs& a = *static_cast<const DenseArgs*>(args);
  if (a.n_pad <= 0 || a.n_pad % 4 != 0 || a.n_pad > kMaxN || a.m_pad <= 0 ||
      a.iters < 0 || a.refine < 0 || a.C < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dense_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.C == 0) return 0;
  dense_loop_kernel<<<a.C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
