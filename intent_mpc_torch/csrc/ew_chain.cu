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
// Design: the five segments (x, then the groups) share one index space of
// equal tiles of kTile4 float4 each; the wrapper
// (intent_mpc_torch/ops/ew_chain.py::work_list) gives each segment's first
// tile, and the grid has one block per tile, so no block is empty and no
// segment sets the tail alone. A thread takes kUnroll float4 of its tile
// (kThreads apart, so each load instruction of the warp is coalesced),
// issues the loads of all of them for every stream before any arithmetic,
// then stores 16 bytes per stream. A segment's ragged end (fewer than 4
// floats) is the last float4 of its last tile: the same thread loads and
// stores its live floats one by one in the same pass. All 39 pointers
// travel in one struct passed by value; the wrapper checks that each is
// 16-byte aligned, allocates the outputs and launches on PyTorch's
// current stream without synchronizing.
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
constexpr int kSegs = 1 + kGroups;      // x, then the groups
constexpr int kThreads = 256;
constexpr int kUnroll = 2;              // float4 per stream in flight per thread
constexpr int kTile4 = kThreads * kUnroll;  // float4 per tile (one block)

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
  int64_t tile0[kSegs + 1];  // first tile of each segment; tile0[kSegs] = grid
  float alpha;
  float beta;  // 1 - alpha, rounded to float once on the host
};

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  float t = v < lo ? lo : v;
  return t > hi ? hi : t;
}

// Float4 i4 of a segment of n floats: 16 bytes at once, or its live floats
// one by one at the segment's ragged end (the rest read as 0).
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        int64_t i4, int64_t n) {
  const int64_t e = 4 * i4;
  if (e + 4 <= n) return __ldg(reinterpret_cast<const float4*>(p) + i4);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (e < n) v.x = __ldg(p + e);
  if (e + 1 < n) v.y = __ldg(p + e + 1);
  if (e + 2 < n) v.z = __ldg(p + e + 2);
  return v;
}

__device__ __forceinline__ void store4(float* __restrict__ p, int64_t i4,
                                       int64_t n, float4 v) {
  const int64_t e = 4 * i4;
  if (e + 4 <= n) {
    reinterpret_cast<float4*>(p)[i4] = v;
    return;
  }
  if (e < n) p[e] = v.x;
  if (e + 1 < n) p[e + 1] = v.y;
  if (e + 2 < n) p[e + 2] = v.z;
}

struct Row {
  float zn, yn, rzy;
};

__device__ __forceinline__ Row chain(float alpha, float beta, float zt,
                                     float z, float y, float rv, float lo,
                                     float hi) {
  const float zr = alpha * zt + beta * z;
  Row r;
  r.zn = clip_keep_nan(zr + y / rv, lo, hi);
  r.yn = y + rv * (zr - r.zn);
  r.rzy = rv * r.zn - r.yn;
  return r;
}

__global__ void __launch_bounds__(kThreads)
ew_chain_kernel(const EwArgs a) {
  const int64_t b = blockIdx.x;
  int seg = 0;
#pragma unroll
  for (int s = 1; s < kSegs; ++s) seg = b >= a.tile0[s] ? s : seg;
  const int64_t first = (b - a.tile0[seg]) * kTile4 + threadIdx.x;
  const float alpha = a.alpha;
  const float beta = a.beta;
  if (seg == 0) {
    const int64_t n = a.n_x;
    float4 xt[kUnroll], xv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i4 = first + k * kThreads;
      xt[k] = load4(a.x_t, i4, n);
      xv[k] = load4(a.x, i4, n);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      float4 o;
      o.x = alpha * xt[k].x + beta * xv[k].x;
      o.y = alpha * xt[k].y + beta * xv[k].y;
      o.z = alpha * xt[k].z + beta * xv[k].z;
      o.w = alpha * xt[k].w + beta * xv[k].w;
      const int64_t i4 = first + k * kThreads;
      if (4 * i4 < n) store4(a.x_n, i4, n, o);
    }
    return;
  }
  const int g = seg - 1;
  const int64_t n = a.n[g];
  float4 zt[kUnroll], z[kUnroll], y[kUnroll], rv[kUnroll], lo[kUnroll],
      hi[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i4 = first + k * kThreads;
    zt[k] = load4(a.zt[g], i4, n);
    z[k] = load4(a.z[g], i4, n);
    y[k] = load4(a.y[g], i4, n);
    rv[k] = load4(a.rho[g], i4, n);
    lo[k] = load4(a.l[g], i4, n);
    hi[k] = load4(a.u[g], i4, n);
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const Row r0 = chain(alpha, beta, zt[k].x, z[k].x, y[k].x, rv[k].x,
                         lo[k].x, hi[k].x);
    const Row r1 = chain(alpha, beta, zt[k].y, z[k].y, y[k].y, rv[k].y,
                         lo[k].y, hi[k].y);
    const Row r2 = chain(alpha, beta, zt[k].z, z[k].z, y[k].z, rv[k].z,
                         lo[k].z, hi[k].z);
    const Row r3 = chain(alpha, beta, zt[k].w, z[k].w, y[k].w, rv[k].w,
                         lo[k].w, hi[k].w);
    const int64_t i4 = first + k * kThreads;
    if (4 * i4 < n) {
      store4(a.z_n[g], i4, n, make_float4(r0.zn, r1.zn, r2.zn, r3.zn));
      store4(a.y_n[g], i4, n, make_float4(r0.yn, r1.yn, r2.yn, r3.yn));
      store4(a.rzy[g], i4, n, make_float4(r0.rzy, r1.rzy, r2.rzy, r3.rzy));
    }
  }
}

}  // namespace

extern "C" int ew_chain_args_size() { return (int)sizeof(EwArgs); }

// Floats per tile of the work list (the wrapper cuts the segments by it).
extern "C" int ew_chain_tile_floats() { return 4 * kTile4; }

// The kernel's registers per thread and local (spill) bytes per thread,
// as the compiler built it; returns the cudaError_t of the query.
extern "C" int ew_chain_resources(int* regs, int* local_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, ew_chain_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = f.numRegs;
  *local_bytes = (int)f.localSizeBytes;
  return 0;
}

// args: host pointer to an EwArgs; stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ew_chain_launch(const void* args, void* stream) {
  const EwArgs& a = *static_cast<const EwArgs*>(args);
  const int64_t tiles = a.tile0[kSegs];
  if (tiles <= 0) return 0;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ew_chain_kernel<<<(unsigned)tiles, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
