// Fused elementwise tail of one ADMM iteration, for every problem of the
// fleet in one launch (sm_90a).
//
// Replaces the TPU kernel intent_mpc_tpu/ops/pallas_ew.py::_ew_kernel
// (:51-68, launched by _ew_pallas :71-113). Per problem it computes
//
//     x_n = alpha * x_t + (1 - alpha) * x
//     and, for each constraint group g in (eq, sb, cb, obs):
//     zr  = alpha * zt + (1 - alpha) * z
//     z_n = clip(zr + y / rho, l, u)
//     y_n = y + rho * (zr - z_n)
//     rzy = rho * z_n - y_n            (feeds the next iteration's A^T)
//
// Bound: memory. There is no reuse: each element is read once and written
// once. Per problem (n = 385 variables, m = 2510 constraint rows at
// horizon 30 with 65 obstacle slots) the kernel reads (2n + 6m) * 4 =
// 63,320 B and writes (n + 3m) * 4 = 31,660 B. At 128 scenarios x 6
// candidates = 768 problems that is 72.9 MB per launch, so at least
// 21.8 us at 3.35 TB/s on an H100 SXM; at 32 scenarios 5.4 us, where
// launch latency dominates.
//
// Design: one launch covers x and the four groups; blockIdx.y picks the
// segment (0 = x, 1..4 = groups) and a grid-stride loop walks that
// segment's contiguous floats. All 39 pointers and the 5 element counts
// travel in one struct passed by value. The wrapper
// (intent_mpc_torch/ops/ew_chain.py) allocates the outputs and launches
// on PyTorch's current stream without synchronizing.
//
// Numerics match the plain PyTorch version bit for bit: it is built with
// -fmad=false (no contraction of a*b + c into an FMA, which would round
// the cancellation y + rho * (zr - z_n) differently at rho = 1e-6 and
// duals near 1e4), divides with IEEE rounding (no fast math), keeps the
// plain version's operation order, and writes the clip as two
// comparisons so that a NaN iterate stays NaN (fminf/fmaxf would drop it
// and hide a broken iterate from the acceptance test).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;

struct EwArgs {
  const float* x;
  const float* x_t;
  const float* z[kGroups];
  const float* y[kGroups];
  const float* zt[kGroups];
  const float* rho[kGroups];
  const float* l[kGroups];
  const float* u[kGroups];
  float* x_n;
  float* z_n[kGroups];
  float* y_n[kGroups];
  float* rzy[kGroups];
  int64_t n_x;
  int64_t n[kGroups];
  float alpha;
  float beta;  // 1 - alpha, rounded to float once on the host
};

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  float t = v < lo ? lo : v;
  return t > hi ? hi : t;
}

__global__ void ew_chain_kernel(const EwArgs a) {
  const int seg = blockIdx.y;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float alpha = a.alpha;
  const float beta = a.beta;
  if (seg == 0) {
    for (; i < a.n_x; i += stride) {
      a.x_n[i] = alpha * a.x_t[i] + beta * a.x[i];
    }
    return;
  }
  const int g = seg - 1;
  const float* __restrict__ z = a.z[g];
  const float* __restrict__ y = a.y[g];
  const float* __restrict__ zt = a.zt[g];
  const float* __restrict__ rho = a.rho[g];
  const float* __restrict__ lo = a.l[g];
  const float* __restrict__ hi = a.u[g];
  float* __restrict__ z_n = a.z_n[g];
  float* __restrict__ y_n = a.y_n[g];
  float* __restrict__ rzy = a.rzy[g];
  const int64_t n = a.n[g];
  for (; i < n; i += stride) {
    const float yv = y[i];
    const float rv = rho[i];
    const float zr = alpha * zt[i] + beta * z[i];
    const float zn = clip_keep_nan(zr + yv / rv, lo[i], hi[i]);
    const float yn = yv + rv * (zr - zn);
    z_n[i] = zn;
    y_n[i] = yn;
    rzy[i] = rv * zn - yn;
  }
}

}  // namespace

extern "C" int ew_chain_args_size() { return (int)sizeof(EwArgs); }

// args: host pointer to an EwArgs; stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ew_chain_launch(const void* args, void* stream) {
  const EwArgs& a = *static_cast<const EwArgs*>(args);
  int64_t longest = a.n_x;
  for (int g = 0; g < kGroups; ++g) longest = a.n[g] > longest ? a.n[g] : longest;
  const int threads = 256;
  int64_t blocks = (longest + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  dim3 grid((unsigned)blocks, 1 + kGroups);
  ew_chain_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
