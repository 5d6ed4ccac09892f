// The scaled constraint operator of the default ADMM iteration, for every
// problem of the batch in one launch (sm_90a): E A D, its transpose and
// the x-update's normal product, with A in closed form (ops/qp.py).
//
// Replaces no TPU kernel: in the JAX package these products are plain
// array code that XLA fuses (ops/qp.py a_matvec / at_matvec under
// ops/admm.py's a_s, at_s and m_apply). On the card they ran as ~50
// PyTorch launches per product, two of them cuBLAS batched gemv over
// (B, W) tiny K x 3 obstacle-gradient matrices. The entries, per problem
// (n = 8H + 5W variables, rows eq (H, 8), sb (H, 8), cb (W, 5), obs (W, K)):
//
//     forward    z = E * A(D x)                               (a_s)
//     transpose  x = D * A^T(E * w)                           (at_s)
//     normal     x = (h_s v + sigma v) + D A^T(E rho E A(D v)) (m_apply)
//
// Bound: memory. One obstacle row reads its gradient G[w, k, :] (12 B),
// its three masks (dyn, act, slk: 12 B) and E (4 B), and rho (4 B) in the
// normal product; a problem holds W K = 1,885 of them at horizon 30 with
// 65 slots, besides 625 linear rows and the n = 385 long x, D and h_s.
// The normal product reads per problem 22,620 B of G, 22,620 of masks,
// 10,040 of rho and 1,540 of v, and writes 1,540; a shared factor's E
// (10,040 B), D and h_s (1,540 each) serve 6 candidates (read at
// candidate stride 0). At 128 scenarios x 6 candidates that is 46.5 MB,
// 13.9 us at 3.35 TB/s (forward and transpose 45.1 MB, 13.5 us). Between
// the iteration's five launches the 44 MB of G, masks, rho and E can stay
// in the 50 MB L2, so a launch may read less from HBM than this count.
// Operations (~30 per obstacle row) are far below the float32 peak.
//
// Design: one block per problem, 256 threads. The problem's D x (or E w)
// and the weighted linear rows live in shared memory (~4.6 kB at horizon
// 30), so the dynamics stencil reads its neighbouring time steps there.
// Each warp takes whole time steps w of the obstacle rows; lane l takes
// slots k = l, l + 32, ...: it reads G[w, k, :] once, forms the row's
// value and, in the normal product, its weighted value and the row's
// transposed contribution without the value leaving registers. The five
// sums of a step over its slots (three gradient components and the two
// slack columns) go lane by lane, then down a fixed shuffle tree, so a
// launch gives the same bits every time (no atomics) and a CUDA-graph
// replay gives the eager run's bits. Then each thread writes whole output
// columns: only the (B, n) result (or the four forward groups) reaches
// device memory.
//
// Numerics: float32 throughout, built with -fmad=false and in the plain
// PyTorch version's operation order for every elementwise step (the
// scalings in the order E, then rho, then E; ts and 0.5 ts^2 rounded to
// float on the host as PyTorch rounds a Python scalar). Only the order of
// the 3-term gradient dot product and of each step's sum over its K slots
// differ from the plain version (and from cuBLAS): a rounding difference
// of a few ulps of the largest term.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNX = 8;
constexpr int kNU = 5;
constexpr int kSums = 5;  // per step: G^T w (3), slack columns u3, u4

enum Mode { kForward = 0, kTranspose = 1, kNormal = 2 };

struct OpArgs {
  const float* x;       // forward, normal: (B, n)
  const float* w[4];    // transpose: the groups eq, sb, cb, obs
  const float* d;       // column scaling (B or B / C, n)
  const float* e[4];    // row scaling, per group
  const float* rho[4];  // normal: the penalty, per group (B, ...)
  const float* hs;      // normal: scaled Hessian diagonal (B or B / C, n)
  const float* g;       // (B, W, K, 3) obstacle gradients
  const float* dyn;     // (B, W, K) 1 where the row's slack is u[3]
  const float* act;     // (B, W, K) live rows
  const float* slk;     // (B, W, K) rows with a slack column
  float* out;           // transpose, normal: (B, n)
  float* z[4];          // forward: the groups
  int64_t problems;     // B
  int32_t cands;        // C: problems per leading group (the last batch axis)
  int32_t horizon;      // H; W = H - 1
  int32_t slots;        // K
  int32_t d_per_cand;   // 1: D has a row per problem; 0: per group of C
  int32_t e_per_cand;
  int32_t hs_per_cand;
  int32_t mode;
  float ts;
  float c2;             // 0.5 ts^2, rounded to float once on the host
  float sigma;
};

// The eq row (i, j) of A z, z in shared memory (X (H, 8), then U (W, 5)).
__device__ __forceinline__ float eq_row(const float* __restrict__ z, int nx,
                                        int i, int j, float ts, float c2) {
  if (i == 0) return -z[j];
  const float* xp = z + kNX * (i - 1);
  const float* xi = z + kNX * i;
  const float* up = z + nx + kNU * (i - 1);
  if (j < 3) return ((xp[j] + ts * xp[j + 3]) + c2 * up[j]) - xi[j];
  if (j < 6) return (xp[j] + ts * up[j - 3]) - xi[j];
  return up[j - 3] - xi[j];
}

template <int M>
__global__ void __launch_bounds__(kThreads)
constraint_op_kernel(const OpArgs a) {
  extern __shared__ float sm[];
  const int H = a.horizon;
  const int W = H - 1;
  const int K = a.slots;
  const int nx = kNX * H;
  const int n = nx + kNU * W;
  const int n_lin = 2 * nx + kNU * W;  // eq, sb, cb rows
  const int64_t b = blockIdx.x;
  const int64_t grp = b / a.cands;
  const int64_t bd = a.d_per_cand ? b : grp;
  const int64_t be = a.e_per_cand ? b : grp;
  const int64_t bh = a.hs_per_cand ? b : grp;
  float* zs = sm;             // n: D x (forward, normal)
  float* wl = sm + n;         // n_lin: the weighted linear rows
  float* red = wl + n_lin;    // kSums W: each step's obstacle-row sums
  const int tid = threadIdx.x;
  const float ts = a.ts;
  const float c2 = a.c2;

  const float* __restrict__ d = a.d + bd * n;
  const float* __restrict__ x = M == kTranspose ? nullptr : a.x + b * n;
  if (M != kTranspose) {
    for (int j = tid; j < n; j += kThreads) zs[j] = d[j] * x[j];
    __syncthreads();
  }

  // linear rows: eq (8H), sb (8H), cb (5W)
  for (int r = tid; r < n_lin; r += kThreads) {
    int g, row;
    int64_t size;
    if (r < nx) {
      g = 0, row = r, size = nx;
    } else if (r < 2 * nx) {
      g = 1, row = r - nx, size = nx;
    } else {
      g = 2, row = r - 2 * nx, size = kNU * W;
    }
    const float ev = a.e[g][be * size + row];
    if (M == kTranspose) {
      wl[r] = a.w[g][b * size + row] * ev;
      continue;
    }
    float v;
    if (g == 0) {
      v = eq_row(zs, nx, row / kNX, row % kNX, ts, c2);
    } else if (g == 1) {
      v = zs[row];
    } else {
      v = zs[nx + row];
    }
    if (M == kForward) {
      a.z[g][b * size + row] = v * ev;
    } else {
      wl[r] = ((v * ev) * a.rho[g][b * size + row]) * ev;
    }
  }

  // obstacle rows: a warp per step, a lane per slot
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t wk = (int64_t)W * K;
  const float* __restrict__ g3 = a.g + b * wk * 3;
  const float* __restrict__ dyn = a.dyn + b * wk;
  const float* __restrict__ act = a.act + b * wk;
  const float* __restrict__ slk = a.slk + b * wk;
  const float* __restrict__ eo = a.e[3] + be * wk;
  for (int w = warp; w < W; w += kWarps) {
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, u3 = 0.0f, u4 = 0.0f;
    if (M != kTranspose) {
      p0 = zs[kNX * w];
      p1 = zs[kNX * w + 1];
      p2 = zs[kNX * w + 2];
      u3 = zs[nx + kNU * w + 3];
      u4 = zs[nx + kNU * w + 4];
    }
    float s[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = lane; k < K; k += 32) {
      const int64_t row = (int64_t)w * K + k;
      const float gx = g3[3 * row];
      const float gy = g3[3 * row + 1];
      const float gz = g3[3 * row + 2];
      const float dy = dyn[row];
      const float ac = act[row];
      const float sl = slk[row];
      const float ev = eo[row];
      float t;
      if (M == kTranspose) {
        t = a.w[3][b * wk + row] * ev;
      } else {
        const float slack = ((dy * u3 + (1.0f - dy) * u4) * sl) * ac;
        const float v = ((gx * p0 + gy * p1) + gz * p2) - slack;
        if (M == kForward) {
          a.z[3][b * wk + row] = v * ev;
          continue;
        }
        t = ((v * ev) * a.rho[3][b * wk + row]) * ev;
      }
      const float wo = t * ac;
      const float ws = wo * sl;
      s[0] = s[0] + wo * gx;
      s[1] = s[1] + wo * gy;
      s[2] = s[2] + wo * gz;
      s[3] = s[3] + ws * dy;
      s[4] = s[4] + ws * (1.0f - dy);
    }
    if (M != kForward) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s[q] = s[q] + __shfl_down_sync(0xffffffffu, s[q], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) red[kSums * w + q] = s[q];
      }
    }
  }
  if (M == kForward) return;
  __syncthreads();

  // A^T of the weighted rows, one output column per thread
  const float* __restrict__ sb = wl + nx;
  const float* __restrict__ cb = wl + 2 * nx;
  float* __restrict__ out = a.out + b * n;
  for (int j = tid; j < n; j += kThreads) {
    float v;
    if (j < nx) {
      const int i = j / kNX, c = j % kNX;
      float atw = 0.0f;  // the row i + 1 dynamics term on x_i
      if (i < W) {
        const float* wn = wl + kNX * (i + 1);
        if (c < 3) {
          atw = wn[c];
        } else if (c < 6) {
          atw = ts * wn[c - 3] + wn[c];
        }
      }
      if (i == 0) {
        v = -wl[c] + atw;
      } else if (i < W) {
        v = atw - wl[kNX * i + c];
      } else {
        v = -wl[kNX * i + c];
      }
      v = v + sb[j];
      if (i < W && c < 3) v = v + red[kSums * i + c];
    } else {
      const int u = j - nx;
      const int i = u / kNU, c = u % kNU;
      const float* wn = wl + kNX * (i + 1);
      if (c < 3) {
        v = c2 * wn[c] + ts * wn[c + 3];
      } else {
        v = wn[c + 3];
      }
      v = v + cb[u];
      if (c >= 3) v = v - red[kSums * i + c];
    }
    const float r = d[j] * v;
    if (M == kTranspose) {
      out[j] = r;
    } else {
      const float* __restrict__ hs = a.hs + bh * n;
      out[j] = (hs[j] * x[j] + a.sigma * x[j]) + r;
    }
  }
}

size_t shared_bytes(const OpArgs& a) {
  const int64_t H = a.horizon, W = H - 1;
  const int64_t n = kNX * H + kNU * W;
  return sizeof(float) * (n + 2 * kNX * H + kNU * W + kSums * W);
}

}  // namespace

extern "C" int constraint_op_args_size() { return (int)sizeof(OpArgs); }

// The normal product's kernel (the largest of the three): registers per
// thread and local (spill) bytes per thread as the compiler built it;
// returns the cudaError_t of the query.
extern "C" int constraint_op_resources(int* regs, int* local_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err =
      cudaFuncGetAttributes(&f, constraint_op_kernel<kNormal>);
  if (err != cudaSuccess) return (int)err;
  *regs = f.numRegs;
  *local_bytes = (int)f.localSizeBytes;
  return 0;
}

// args: host pointer to an OpArgs; stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int constraint_op_launch(const void* args, void* stream) {
  const OpArgs& a = *static_cast<const OpArgs*>(args);
  if (a.problems <= 0) return 0;
  if (a.problems > 0x7fffffff || a.horizon < 2 || a.slots < 1 ||
      a.cands < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(a);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.problems);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.mode) {
    case kForward:
      constraint_op_kernel<kForward><<<grid, kThreads, smem, s>>>(a);
      break;
    case kTranspose:
      constraint_op_kernel<kTranspose><<<grid, kThreads, smem, s>>>(a);
      break;
    case kNormal:
      constraint_op_kernel<kNormal><<<grid, kThreads, smem, s>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
