// mule_agg for Hopper (sm_90a): out[F, D] = A[F, M] @ W[M, D].
//
// Replaces the Pallas TPU kernel src/repro/kernels/mule_agg/kernel.py
// (_agg_kernel / mule_agg_pallas): the dwell-weighted group mean of the
// flattened mule population at the F fixed devices.
//
// What bounds it: memory. Every element of W is read once and feeds F <= 16
// fused multiply-adds, far below the ~20 FLOP per byte at which the card's
// fp32 rate would take over, so the least time is the bytes of W over the
// memory rate.
//
// Design (simple and right first):
// - One thread per output column d. A block of kThreads threads owns a strip
//   of kThreads consecutive columns and walks m, so a warp reads 128
//   contiguous bytes of row m of W per step (coalesced).
// - A stays resident in shared memory, staged in chunks of MC rows of m so
//   that F_MAX * MC floats take 16 KB whatever M is. Every thread of a warp
//   reads the same A entries, which shared memory broadcasts.
// - Each thread keeps its F sums in registers. F is bounded at compile time
//   by the template F_MAX; rows f >= F are computed and never stored.
// - The ragged D edge is masked here, so W is never padded or copied.
// - Accumulation is fp32; the output takes W's type (f32 or bf16).
// - Lanes (a seed sweep's S populations, mule_agg_lanes_*) are gridDim.y:
//   block row s offsets A, W and out by lane s's strides and runs the
//   single-lane code unchanged, so each lane has the bits of a single-lane
//   launch on its inputs, in one launch for all lanes.
// - The launch allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int F_MAX, typename T>
__global__ void __launch_bounds__(kThreads)
    mule_agg_kernel(const float* __restrict__ A, const T* __restrict__ W,
                    T* __restrict__ out, int F, int M, int64_t D) {
  constexpr int MC = 4096 / F_MAX;  // rows of A per chunk: 16 KB of floats
  __shared__ float sA[MC][F_MAX];   // sA[j][f] = A[f, m0 + j]

  const int64_t lane = blockIdx.y;  // this lane's A [F, M], W [M, D], out
  A += lane * F * M;
  W += lane * M * D;
  out += lane * F * D;

  const int64_t d = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < D;

  float acc[F_MAX];
#pragma unroll
  for (int f = 0; f < F_MAX; ++f) acc[f] = 0.f;

  for (int m0 = 0; m0 < M; m0 += MC) {
    const int mc = min(MC, M - m0);
    __syncthreads();  // every thread is done with the previous chunk
    // consecutive threads read consecutive m of one row of A
    for (int i = threadIdx.x; i < F_MAX * mc; i += kThreads) {
      const int f = i / mc, j = i - f * mc;
      sA[j][f] = f < F ? A[(int64_t)f * M + m0 + j] : 0.f;
    }
    __syncthreads();
    if (live) {
      const T* w = W + (int64_t)m0 * D + d;
#pragma unroll 4
      for (int j = 0; j < mc; ++j) {
        const float x = load_f32(w + (int64_t)j * D);
#pragma unroll
        for (int f = 0; f < F_MAX; ++f) acc[f] = fmaf(sA[j][f], x, acc[f]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int f = 0; f < F_MAX; ++f)
      if (f < F) store_f32(out + (int64_t)f * D + d, acc[f]);
  }
}

template <typename T>
int launch(const void* A, const void* W, void* out, int S, int F, int M,
           long long D, void* stream) {
  if (S < 1 || S > 65535 || F < 1 || F > 16 || M < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const T* w = static_cast<const T*>(W);
  T* o = static_cast<T*>(out);
  if (F <= 1)
    mule_agg_kernel<1, T><<<grid, kThreads, 0, s>>>(a, w, o, F, M, D);
  else if (F <= 2)
    mule_agg_kernel<2, T><<<grid, kThreads, 0, s>>>(a, w, o, F, M, D);
  else if (F <= 4)
    mule_agg_kernel<4, T><<<grid, kThreads, 0, s>>>(a, w, o, F, M, D);
  else if (F <= 8)
    mule_agg_kernel<8, T><<<grid, kThreads, 0, s>>>(a, w, o, F, M, D);
  else
    mule_agg_kernel<16, T><<<grid, kThreads, 0, s>>>(a, w, o, F, M, D);
  return (int)cudaGetLastError();
}

}  // namespace

// S lanes in one launch (S = 1: a single call): A [S, F, M], W [S, M, D]
// -> out [S, F, D]
extern "C" int mule_agg_lanes_f32(const void* A, const void* W, void* out,
                                  int S, int F, int M, long long D,
                                  void* stream) {
  return launch<float>(A, W, out, S, F, M, D, stream);
}

extern "C" int mule_agg_lanes_bf16(const void* A, const void* W, void* out,
                                   int S, int F, int M, long long D,
                                   void* stream) {
  return launch<__nv_bfloat16>(A, W, out, S, F, M, D, stream);
}
