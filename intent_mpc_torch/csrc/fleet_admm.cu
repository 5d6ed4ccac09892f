// Fleet-fused ADMM: every iteration of every candidate QP of a cycle in
// one launch (sm_90a).
//
// Replaces the TPU kernel intent_mpc_tpu/ops/pallas_fused.py::_fleet_kernel
// (:300-413, launched by fleet_solve :416-495). Per scenario s and live
// candidate c (inputs packed by intent_mpc_torch/ops/fleet.py::pack_fleet,
// layout (S, 8, rows) and (S, 8, W, K), slot 6 and 7 inert):
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
// Design. One thread block per scenario runs the whole solve; scenarios
// are independent, so there is no grid-wide synchronisation and the solve
// is one launch (128 blocks on 132 SMs at 128 scenarios). The block keeps
// the live candidates' vectors (x, x-tilde, rhs, a scratch vector, the
// A_ext image and the linear-row z and y) in 98 KB of shared memory,
// candidate-major so that a row walk of one candidate is conflict-free.
// One scenario's Minv (512 x 512 float32 = 1 MiB) does not fit in an SM,
// so every apply streams its live n x n block from L2/HBM: one warp per
// row, float4 loads along the row, a shuffle reduction per candidate. The
// shared A_ext (792 x 512, ~1.3k nonzeros) is applied as CSR (built on the
// host from the same numpy construction, columns ascending), and its
// transpose as the CSR of A_ext^T. The obstacle rows (W x K per candidate)
// and the z_obs/y_obs iterates stay in global memory; one warp walks the
// K slots of one (candidate, step) row and reduces the five A^T sums with
// shuffles, so every sum has a fixed order and the kernel is
// deterministic. Slots 6 and 7 hold no candidate and are skipped; their
// outputs are written as zeros.
//
// Bound: operations. Per scenario and iteration the kernel does
// (1 + refine) Minv applies (2 n^2 flops per live candidate, n = 385) and
// 2 + 2 refine sparse A_ext products; each input is needed once, so the
// bytes (the live Minv blocks dominate: 76 MB at 128 scenarios) take
// ~0.05 ms at 3.35 TB/s against ~1.2 ms of float32 work at 67 TFLOP/s
// for 100 iterations. The kernel is far from that bound: it re-streams
// Minv on every apply, and each block is one SM working through the
// per-iteration phases with a __syncthreads between them.
//
// Precision: every product is IEEE float32 on the CUDA cores, with
// explicit __fmaf_rn in the Minv and A_ext dot products (the library is
// built with -fmad=false, which only stops the compiler from contracting
// a*b + c on its own). The elementwise updates stay uncontracted, in the
// plain version's order. No TF32 and no tensor cores: on these QPs the
// duals ramp to 1e4-1e5 while x stays ~1e1, and every cheaper precision
// diverged on the TPU (pallas_fused.py:264-272). Non-finite values
// propagate along the nonzeros of A_ext (the plain version's dense
// product would spread them over the whole candidate at once); the next
// dense Minv apply does the same, so a broken candidate still ends
// non-finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;     // candidate slots per scenario in the layout
constexpr int kLive = 6;      // live candidates (slots 6, 7 are inert)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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
  const float* gx;      // (S, 8, W, K)
  const float* gy;
  const float* gz;
  const float* s3;
  const float* s4;
  const float* ro;
  const float* iro;
  const float* loo;
  float* x_out;         // (S, 8, n_pad)
  float* yl_out;        // (S, 8, lin_pad)
  float* yo_out;        // (S, 8, W, K), also the y_obs iterate
  float* zo;            // (S, 8, W, K), the z_obs iterate
  int S, n, n_pad, lin_pad, W, Wp, K, n_ext, iters, refine;
  float sigma, alpha, beta;  // beta = 1 - alpha, rounded to float on the host
};

// What an obstacle or linear-row pass computes from the fresh A_ext image.
enum Pass {
  kInit,    // z = a_s(x0), y = 0; emit the first rhs's A^T input
  kMApply,  // emit the A^T input of m_apply: rho * a_s(v)
  kUpdate,  // over-relaxed z/y update; emit the next rhs's A^T input
};

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  const float t = v < lo ? lo : v;
  return t > hi ? hi : t;
}

__device__ __forceinline__ float max_keep_nan(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// out[c][r] = sum_p val[p] * in[c][col[p]] over the CSR rows r < rows, for
// the live candidates; in has stride in_len, out stride rows.
__device__ void csr_apply(const int* __restrict__ ptr,
                          const int* __restrict__ col,
                          const float* __restrict__ val, int rows,
                          const float* in, int in_len, float* out) {
  for (int i = threadIdx.x; i < kLive * rows; i += kThreads) {
    const int c = i / rows;
    const int r = i - c * rows;
    const float* v = in + c * in_len;
    float acc = 0.0f;
    const int end = __ldg(ptr + r + 1);
    for (int p = __ldg(ptr + r); p < end; ++p)
      acc = __fmaf_rn(__ldg(val + p), v[__ldg(col + p)], acc);
    out[c * rows + r] = acc;
  }
  __syncthreads();
}

// out[c][i] = (out[c][i] if kAdd) + sum_{j<n} m[i][j] * in[c][j] for the
// live rows i < n; without kAdd the pad rows n..n_pad-1 become 0. One warp
// per row; the row's columns stream as float4 (the pad columns of Minv
// past n are zero, and so are in's pad rows).
template <bool kAdd>
__device__ void minv_apply(const float* __restrict__ m, int n, int n_pad,
                           const float* in, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n4 = (n + 3) >> 2;
  for (int i = warp; i < n; i += kWarps) {
    const float4* row = reinterpret_cast<const float4*>(m + (size_t)i * n_pad);
    float acc[kLive];
#pragma unroll
    for (int c = 0; c < kLive; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int j4 = lane; j4 < n4; j4 += 32) {
      const float4 a = __ldg(row + j4);
#pragma unroll
      for (int c = 0; c < kLive; ++c) {
        const float4 v = reinterpret_cast<const float4*>(in + c * n_pad)[j4];
        acc[c] = __fmaf_rn(a.x, v.x, acc[c]);
        acc[c] = __fmaf_rn(a.y, v.y, acc[c]);
        acc[c] = __fmaf_rn(a.z, v.z, acc[c]);
        acc[c] = __fmaf_rn(a.w, v.w, acc[c]);
      }
    }
    float mine = 0.0f;
#pragma unroll
    for (int c = 0; c < kLive; ++c) {
      const float s = warp_sum(acc[c]);
      if (lane == c) mine = s;
    }
    if (lane < kLive) {
      float* o = out + lane * n_pad + i;
      *o = kAdd ? *o + mine : mine;
    }
  }
  if (!kAdd) {
    const int pad = n_pad - n;
    for (int k = threadIdx.x; k < kLive * pad; k += kThreads) {
      const int c = k / pad;
      out[c * n_pad + n + (k - c * pad)] = 0.0f;
    }
  }
  __syncthreads();
}

// Per-block views of one scenario's inputs and iterates.
struct Scenario {
  const float *d, *q, *hs, *x0;          // (8, n_pad)
  const float *el, *rl, *irl, *lol, *hil;  // (8, lin_pad)
  const float *gx, *gy, *gz, *s3, *s4, *ro, *iro, *loo;  // (8, W, K)
  float *zo, *yo;
};

// The linear rows of a pass (r < lin_pad) read the A_ext image sE and
// replace it, in place, by the A^T input E * w_lin.
template <Pass kPass>
__device__ void linear_rows(const FleetArgs& a, const Scenario& sc, float* sE,
                            float* sZl, float* sYl) {
  const int lp = a.lin_pad;
  for (int i = threadIdx.x; i < kLive * lp; i += kThreads) {
    const int c = i / lp;
    float* e = sE + c * a.n_ext + (i - c * lp);
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

// The obstacle rows of a pass: one warp per (candidate, step) row reads the
// five copy rows of the A_ext image at that step, walks the K slots, and
// writes the five A^T sums back into the same copy rows.
template <Pass kPass>
__device__ void obstacle_rows(const FleetArgs& a, const Scenario& sc,
                              float* sE) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = a.W, K = a.K, Wp = a.Wp;
  for (int item = warp; item < kLive * W; item += kWarps) {
    const int c = item / W;
    const int w = item - c * W;
    float* e = sE + c * a.n_ext + a.lin_pad + w;
    const float px = e[0], py = e[Wp], pz = e[2 * Wp];
    const float u3 = e[3 * Wp], u4 = e[4 * Wp];
    const int base = item * K;   // ((c * W) + w) * K
    float cx = 0.0f, cy = 0.0f, cz = 0.0f, c3 = 0.0f, c4 = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const int o = base + k;
      const float gx = sc.gx[o], gy = sc.gy[o], gz = sc.gz[o];
      const float s3 = sc.s3[o], s4 = sc.s4[o], ro = sc.ro[o];
      const float zt = gx * px + gy * py + gz * pz + s3 * u3 + s4 * u4;
      float wo;
      if (kPass == kInit) {
        sc.zo[o] = zt;
        sc.yo[o] = 0.0f;
        wo = ro * zt - 0.0f;
      } else if (kPass == kMApply) {
        wo = ro * zt;
      } else {
        const float z = sc.zo[o];
        const float y = sc.yo[o];
        const float zr = a.alpha * zt + a.beta * z;
        const float zn = max_keep_nan(zr + y * sc.iro[o], sc.loo[o]);
        const float yn = y + ro * (zr - zn);
        sc.zo[o] = zn;
        sc.yo[o] = yn;
        wo = ro * zn - yn;
      }
      cx += wo * gx;
      cy += wo * gy;
      cz += wo * gz;
      c3 += wo * s3;
      c4 += wo * s4;
    }
    cx = warp_sum(cx);
    cy = warp_sum(cy);
    cz = warp_sum(cz);
    c3 = warp_sum(c3);
    c4 = warp_sum(c4);
    if (lane == 0) {
      e[0] = cx;
      e[Wp] = cy;
      e[2 * Wp] = cz;
      e[3 * Wp] = c3;
      e[4 * Wp] = c4;
    }
  }
}

// sE = A_ext (d * v), then the pass turns it into the A^T input.
template <Pass kPass>
__device__ void a_s_pass(const FleetArgs& a, const Scenario& sc,
                         const float* v, float* sT, float* sE, float* sZl,
                         float* sYl) {
  for (int i = threadIdx.x; i < kLive * a.n_pad; i += kThreads)
    sT[i] = sc.d[i] * v[i];
  __syncthreads();
  csr_apply(a.a_ptr, a.a_col, a.a_val, a.n_ext, sT, a.n_pad, sE);
  linear_rows<kPass>(a, sc, sE, sZl, sYl);
  obstacle_rows<kPass>(a, sc, sE);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
fleet_admm_kernel(const FleetArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_pad = a.n_pad, lp = a.lin_pad;
  float* sX = smem;                    // x            (kLive, n_pad)
  float* sXt = sX + kLive * n_pad;     // x-tilde      (kLive, n_pad)
  float* sRhs = sXt + kLive * n_pad;   // rhs          (kLive, n_pad)
  float* sT = sRhs + kLive * n_pad;    // scratch      (kLive, n_pad)
  float* sE = sT + kLive * n_pad;      // A_ext image  (kLive, n_ext)
  float* sZl = sE + kLive * a.n_ext;   // z, linear    (kLive, lin_pad)
  float* sYl = sZl + kLive * lp;       // y, linear    (kLive, lin_pad)

  const int s = blockIdx.x;
  const size_t vn = (size_t)s * kLanes * n_pad;
  const size_t vl = (size_t)s * kLanes * lp;
  const size_t vo = (size_t)s * kLanes * a.W * a.K;
  Scenario sc;
  sc.d = a.d + vn;
  sc.q = a.q + vn;
  sc.hs = a.hs + vn;
  sc.x0 = a.x0 + vn;
  sc.el = a.el + vl;
  sc.rl = a.rl + vl;
  sc.irl = a.irl + vl;
  sc.lol = a.lol + vl;
  sc.hil = a.hil + vl;
  sc.gx = a.gx + vo;
  sc.gy = a.gy + vo;
  sc.gz = a.gz + vo;
  sc.s3 = a.s3 + vo;
  sc.s4 = a.s4 + vo;
  sc.ro = a.ro + vo;
  sc.iro = a.iro + vo;
  sc.loo = a.loo + vo;
  sc.zo = a.zo + vo;
  sc.yo = a.yo_out + vo;
  const float* minv = a.minv + (size_t)s * n_pad * n_pad;
  const int nv = kLive * n_pad;

  for (int i = threadIdx.x; i < nv; i += kThreads) sX[i] = sc.x0[i];
  __syncthreads();
  a_s_pass<kInit>(a, sc, sX, sT, sE, sZl, sYl);

  for (int it = 0; it < a.iters; ++it) {
    // rhs = sigma x - q + d * A^T(w); sE holds w from the previous pass
    csr_apply(a.at_ptr, a.at_col, a.at_val, n_pad, sE, a.n_ext, sT);
    for (int i = threadIdx.x; i < nv; i += kThreads)
      sRhs[i] = a.sigma * sX[i] - sc.q[i] + sc.d[i] * sT[i];
    __syncthreads();
    minv_apply<false>(minv, a.n, n_pad, sRhs, sXt);
    for (int r = 0; r < a.refine; ++r) {
      // residual rhs - (hs xt + at_s(rho a_s(xt))), then xt += Minv residual
      a_s_pass<kMApply>(a, sc, sXt, sT, sE, sZl, sYl);
      csr_apply(a.at_ptr, a.at_col, a.at_val, n_pad, sE, a.n_ext, sT);
      for (int i = threadIdx.x; i < nv; i += kThreads)
        sT[i] = sRhs[i] - (sc.hs[i] * sXt[i] + sc.d[i] * sT[i]);
      __syncthreads();
      minv_apply<true>(minv, a.n, n_pad, sT, sXt);
    }
    // z/y update from a_s(xt); x blend
    a_s_pass<kUpdate>(a, sc, sXt, sT, sE, sZl, sYl);
    for (int i = threadIdx.x; i < nv; i += kThreads)
      sX[i] = a.alpha * sXt[i] + a.beta * sX[i];
    __syncthreads();
  }

  float* x_out = a.x_out + vn;
  float* yl_out = a.yl_out + vl;
  for (int i = threadIdx.x; i < kLanes * n_pad; i += kThreads)
    x_out[i] = i < nv ? sX[i] : 0.0f;
  for (int i = threadIdx.x; i < kLanes * lp; i += kThreads)
    yl_out[i] = i < kLive * lp ? sYl[i] : 0.0f;
  const int no = a.W * a.K;
  for (int i = kLive * no + threadIdx.x; i < kLanes * no; i += kThreads)
    sc.yo[i] = 0.0f;
}

size_t smem_bytes(const FleetArgs& a) {
  return sizeof(float) * kLive * (4 * (size_t)a.n_pad + a.n_ext + 2 * (size_t)a.lin_pad);
}

}  // namespace

extern "C" int fleet_admm_args_size() { return (int)sizeof(FleetArgs); }

// args: host pointer to a FleetArgs; stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success). The wrapper
// (intent_mpc_torch/ops/fleet.py) checks shapes; n_pad must be a multiple
// of 4 for the float4 row loads.
extern "C" int fleet_admm_launch(const void* args, void* stream) {
  const FleetArgs& a = *static_cast<const FleetArgs*>(args);
  if (a.n_pad % 4 != 0 || a.n > a.n_pad) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(
      fleet_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.S == 0) return 0;
  fleet_admm_kernel<<<a.S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
