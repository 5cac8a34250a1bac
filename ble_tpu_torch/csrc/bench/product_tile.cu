// What bounds the query engine's product (csrc/gp_query_core.cuh): its
// inner loop alone, over shared-memory operands laid out as the engine's,
// on 4096 CTAs of 256 threads (two an SM, as in B2 and B5), in four forms:
//   V0  the engine's: a thread 4 levels x 8 slots, one float4 of k* and two
//       of kinv a step for 32 FMAs;
//   V1  the same FMAs with one float4 load a step (kinv taken from it);
//   V2  the same FMAs with no shared load;
//   V3  an 8x8 thread tile (two float4 of each operand for 64 FMAs) on half
//       the threads, the occupancy an 8x8 tile of a 64-level chunk leaves;
//   V4  an 8x8 thread tile on all threads: the two half-warps take the two
//       halves of the sum over a for the same tiles and add their partial
//       products with one shuffle each at the end.
// Run by chip_smoke.py --phases device,tile.
#include <cuda_runtime.h>
constexpr int kCap = 128, kKinvStride = 132, kKsStride = 68;
constexpr int kSmemBytes =
    (kCap * kKinvStride + kCap * kKsStride + 4096) * 4;

template <int V>
__global__ void __launch_bounds__(256, 2) prod(float* out, int iters) {
  extern __shared__ __align__(16) float smem[];
  float* kinv = smem;
  float* kstar = smem + kCap * kKinvStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kCap * kKinvStride; i += 256)
    kinv[i] = 1e-3f * (i % 97);
  for (int i = tid; i < kCap * kKsStride; i += 256)
    kstar[i] = 1e-3f * (i % 89);
  __syncthreads();
  float sum = 0.0f;
  if (V == 4) {
    // lane -> (half kh of the sum over a, level group lg, slot group jg);
    // warp -> (16-level range lr, 64-slot half sh).
    const int kh = lane >> 4, lg = lane & 1, jg = (lane >> 1) & 7;
    const int lr = warp & 3, sh = warp >> 2;
    const int lc = lr * 16 + 8 * lg, jb = sh * 64 + 4 * jg;
    for (int it = 0; it < iters; ++it) {
      float acc[8][8] = {};
#pragma unroll 2
      for (int a = kh * 64; a < kh * 64 + 64; ++a) {
        const float* kr = kstar + a * kKsStride + lc;
        const float* vr = kinv + a * kKinvStride + jb;
        const float4 k0 = *reinterpret_cast<const float4*>(kr);
        const float4 k1 = *reinterpret_cast<const float4*>(kr + 4);
        const float4 v0 = *reinterpret_cast<const float4*>(vr);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + 32);
        const float ks[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        const float kv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(ks[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float give = kh ? acc[i][j] : acc[4 + i][j];
          const float keep = kh ? acc[4 + i][j] : acc[i][j];
          sum += keep + __shfl_xor_sync(0xffffffffu, give, 16);
        }
    }
  } else if (V == 3) {
    // 8 levels x 8 slots a thread, 128 threads (half the CTA idle): warp ->
    // 16 levels x 128 slots.
    if (warp < 4) {
      const int lg = lane & 1, jg = lane >> 1;
      const int lc = warp * 16 + 8 * lg, jb = 4 * jg;
      for (int it = 0; it < iters; ++it) {
        float acc[8][8] = {};
#pragma unroll 2
        for (int a = 0; a < kCap; ++a) {
          const float* kr = kstar + a * kKsStride + lc;
          const float* vr = kinv + a * kKinvStride + jb;
          const float4 k0 = *reinterpret_cast<const float4*>(kr);
          const float4 k1 = *reinterpret_cast<const float4*>(kr + 4);
          const float4 v0 = *reinterpret_cast<const float4*>(vr);
          const float4 v1 = *reinterpret_cast<const float4*>(vr + 64);
          const float ks[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
          const float kv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(ks[i], kv[j], acc[i][j]);
        }
        for (int i = 0; i < 8; ++i)
          for (int j = 0; j < 8; ++j) sum += acc[i][j];
      }
    }
  } else {
    const int lr = warp & 3, sh = warp >> 2, lg = lane & 3, jg = lane >> 2;
    const int lc = lr * 16 + 4 * lg, jb = sh * 64 + 4 * jg;
    for (int it = 0; it < iters; ++it) {
      float acc[4][8] = {};
      float4 r0 = make_float4(1e-3f * lane, 2e-3f, 3e-3f, 4e-3f);
      float4 r1 = make_float4(5e-3f, 6e-3f, 7e-3f * warp, 8e-3f);
#pragma unroll 4
      for (int a = 0; a < kCap; ++a) {
        float4 k4, v0, v1;
        if (V == 2) {
          k4 = make_float4(r0.x + a, r0.y, r0.z, r0.w);
          v0 = r0; v1 = r1;
        } else {
          k4 = *reinterpret_cast<const float4*>(kstar + a * kKsStride + lc);
          if (V == 0) {
            const float* vr = kinv + a * kKinvStride + jb;
            v0 = *reinterpret_cast<const float4*>(vr);
            v1 = *reinterpret_cast<const float4*>(vr + 32);
          } else {
            v0 = k4; v1 = make_float4(k4.w, k4.z, k4.y, k4.x);
          }
        }
        const float ks[4] = {k4.x, k4.y, k4.z, k4.w};
        const float kv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ks[i], kv[j], acc[i][j]);
      }
      for (int i = 0; i < 4; ++i) for (int j = 0; j < 8; ++j) sum += acc[i][j];
    }
  }
  out[blockIdx.x * 256 + tid] = sum;
}

extern "C" int run(int v, float* out, int n, int iters, cudaStream_t s) {
  void (*fns[5])(float*, int) = {prod<0>, prod<1>, prod<2>, prod<3>,
                                 prod<4>};
  cudaFuncSetAttribute(fns[v], cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  fns[v]<<<n, 256, kSmemBytes, s>>>(out, iters);
  return (int)cudaGetLastError();
}
