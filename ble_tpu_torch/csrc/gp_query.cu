// GP posterior at a column of pressures for Hopper (sm_90a).
//
// Replaces the TPU kernel ble_tpu/ops/pallas_gp.py:query_column (B5,
// kernel _kernel): for each env, N query points share the env's (x, y, t)
// and differ in pressure; k*[l, a] = s_f^2 exp(-|q_l - loc_a| / ls) on the
// active slots, means = k* alpha, v = k* kinv and
// dev = clip((s_f^2 - sum_a k*[l, a] v[l, a]) / s_f^2, 0, 1); both are zero
// for an env with no active slot.
//
// Design: one CTA of 256 threads per env. The env's 128x128 float32 inverse
// is read once into dynamic shared memory (rows padded to 129 floats). The
// x/y/t part of the distance is built once as a (128,) vector, as the TPU
// kernel does; k* is then built 64 levels at a time in shared memory, the
// ragged last chunk masked (N is an input), and v = k* kinv is formed with
// an 8x4 register tile per thread in full float32 on the CUDA cores: no
// TF32 and no tensor cores, because the variance cancels operands of ~13
// down to s_n^2 = 0.05 (ble_tpu/env/wind_gp.py:36-44).
//
// Bound, per env at N = 181: ~6.1 MFLOP, dominated by v = k* kinv at
// 2 x 181 x 128 x 128, against ~71 KiB of traffic (kinv in, the levels
// out); at 4096 envs that is ~25 GFLOP (0.37 ms at 67 TFLOP/s) and ~290 MB
// (0.09 ms at 3.35 TB/s): compute-bound on the float32 CUDA cores.

#include <cuda_runtime.h>

#include "gp_core.cuh"

namespace {

using namespace ble_gp;

constexpr int kChunk = 64;
constexpr int kRowGroups = 16;  // v tile: 16 slot groups x 16 level groups.
constexpr int kTileRows = kCap / kRowGroups;  // 8
constexpr int kTileCols = kChunk / 16;  // 4

// Shared memory layout, in floats.
constexpr int kOffKinv = 0;
constexpr int kOffLoc = kOffKinv + kCap * kKinvStride;
constexpr int kOffAct = kOffLoc + kCap * 4;
constexpr int kOffAlpha = kOffAct + kCap;
constexpr int kOffQc = kOffAlpha + kCap * 2;
constexpr int kOffKstar = kOffQc + kCap;
constexpr int kOffRed = kOffKstar + kCap * kChunk;
constexpr int kSmemFloats = kOffRed + kRowGroups * kChunk;
constexpr int kSmemBytes = kSmemFloats * 4;

__global__ void __launch_bounds__(kThreads, 2)
gp_query_kernel(const float* __restrict__ loc_in,
                const float* __restrict__ act_in,
                const float* __restrict__ alpha_in,
                const float* __restrict__ kinv_in,
                const float* __restrict__ q_in,
                const float* __restrict__ pres, float* __restrict__ out,
                int n_levels) {
  extern __shared__ float smem[];
  float* kinv = smem + kOffKinv;
  float* loc = smem + kOffLoc;
  float* act = smem + kOffAct;
  float* alpha = smem + kOffAlpha;
  float* qc = smem + kOffQc;
  float* kstar = smem + kOffKstar;  // (CAP, kChunk): slot-major.
  float* red = smem + kOffRed;

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const float sf2 = F(kSigmaF2);

  {
    const float4* src =
        reinterpret_cast<const float4*>(kinv_in + (size_t)e * kCap * kCap);
    for (int i = tid; i < kCap * kCap / 4; i += kThreads) {
      float4 q = src[i];
      int r = (i * 4) / kCap, c = (i * 4) % kCap;
      float* dst = kinv + r * kKinvStride + c;
      dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
    }
    for (int i = tid; i < kCap * 4; i += kThreads)
      loc[i] = loc_in[(size_t)e * kCap * 4 + i];
    for (int i = tid; i < kCap * 2; i += kThreads)
      alpha[i] = alpha_in[(size_t)e * kCap * 2 + i];
  }
  // The x/y/t part of each slot's distance to the column, and the active
  // mask (pallas_gp._kernel's lane vector c).
  if (tid < kCap) {
    const float* q = q_in + (size_t)e * 4;
    const float* lo = loc_in + ((size_t)e * kCap + tid) * 4;
    float dx = (q[0] - lo[0]) / F(kLsX);
    float dy = (q[1] - lo[1]) / F(kLsY);
    float dt = (q[2] - lo[3]) / F(kLsT);
    qc[tid] = dx * dx + dy * dy + dt * dt + F(1e-12);
    act[tid] = act_in[(size_t)e * kCap + tid];
  }
  const float any_valid =
      __syncthreads_or(tid < kCap && act_in[(size_t)e * kCap + tid] > 0.0f)
          ? 1.0f : 0.0f;

  float* lvl = out + (size_t)e * n_levels * 3;
  for (int l0 = 0; l0 < n_levels; l0 += kChunk) {
    // k* chunk; levels past N are zero columns.
    for (int idx = tid; idx < kCap * kChunk; idx += kThreads) {
      const int a = idx / kChunk, l = l0 + idx % kChunk;
      float ks = 0.0f;
      if (l < n_levels) {
        float dp = (pres[l] - loc[a * 4 + 2]) / F(kLsP);
        float d = sqrtf(qc[a] + dp * dp);
        ks = (sf2 * expf(-d)) * act[a];
      }
      kstar[idx] = ks;
    }
    __syncthreads();

    if (tid < 2 * kChunk) {
      const int jl = tid % kChunk, comp = tid / kChunk, l = l0 + jl;
      if (l < n_levels) {
        float acc = 0.0f;
        for (int a = 0; a < kCap; ++a)
          acc += kstar[a * kChunk + jl] * alpha[a * 2 + comp];
        lvl[l * 3 + comp] = acc * any_valid;
      }
    }

    // v[l, j] = sum_a k*[l, a] kinv[a, j] for slots j of this thread's row
    // group and levels of its column group, then k*[l, j] v[l, j] summed
    // over the group's slots.
    {
      const int rg = tid / 16, cg = tid % 16;
      float acc[kTileRows][kTileCols];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int jj = 0; jj < kTileCols; ++jj) acc[i][jj] = 0.0f;
      for (int a = 0; a < kCap; ++a) {
        float b[kTileCols];
#pragma unroll
        for (int jj = 0; jj < kTileCols; ++jj)
          b[jj] = kstar[a * kChunk + cg + 16 * jj];
        const float* krow = kinv + a * kKinvStride + rg * kTileRows;
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          float k = krow[i];
#pragma unroll
          for (int jj = 0; jj < kTileCols; ++jj) acc[i][jj] += k * b[jj];
        }
      }
#pragma unroll
      for (int jj = 0; jj < kTileCols; ++jj) {
        const int col = cg + 16 * jj;
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
          part += kstar[(rg * kTileRows + i) * kChunk + col] * acc[i][jj];
        red[rg * kChunk + col] = part;
      }
    }
    __syncthreads();

    if (tid < kChunk) {
      const int l = l0 + tid;
      if (l < n_levels) {
        float sum = 0.0f;
        for (int g = 0; g < kRowGroups; ++g) sum += red[g * kChunk + tid];
        float var = sf2 - sum;
        float dev = fminf(fmaxf(var / sf2, 0.0f), 1.0f);
        lvl[l * 3 + 2] = dev * any_valid;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// loc (n, 128, 4), act (n, 128) as 0/1 floats, alpha (n, 128, 2), kinv
// (n, 128, 128), q (n, 4) = [x, y, t, 0], pres (n_levels,); out
// (n, n_levels, 3) = [mean_u, mean_v, deviation]. Returns the first CUDA
// error of the attribute call or the launch.
extern "C" int ble_gp_query(const float* loc, const float* act,
                            const float* alpha, const float* kinv,
                            const float* q, const float* pres, float* out,
                            int n, int n_levels, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gp_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && n_levels > 0) {
    gp_query_kernel<<<n, kThreads, kSmemBytes, stream>>>(
        loc, act, alpha, kinv, q, pres, out, n_levels);
  }
  return (int)cudaGetLastError();
}
