// encounter_mix for Hopper (sm_90a): the fused peer-encounter mix, and one
// ring hop of it.
//
//   e[i, j] = (d2(i, j) <= r2) & area[i] == area[j] & active[i] & active[j]
//             & i != j
//   mass[i] = sum_j e[i, j]
//   mix[i]  = (sum_j e[i, j] * W[j]) / max(mass[i], 1e-12)
//
// pos [M, 2] f32, area [M] int64, active [M] uint8, W [M, D] f32 or bf16 ->
// mix [M, D] in W's type, mass [M] f32. The [M, M] matrix e is never stored.
//
// The hop (encounter_hop_f32) is the same tile with rows and visiting
// mules apart: local rows [R] (pos_r, area_r, active_r, global ids row0 +
// i) against a visiting block [V] (pos_v, area_v, active_v, global ids
// col0 + j, weights W_v [V, D] f32). It writes the unnormalised partials
// acc [R, D] = e @ W_v and mass [R] in f32, which the ring sums over its
// hops and normalises once. Global ids are int64 (the JAX kernel carries
// them as float32, exact only below 2^24 rows).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/encounter_mix/
// kernel.py: _mix_kernel / encounter_mix_pallas, which builds one
// [block_m, M] strip of e per (row block, d block) tile and multiplies it
// on the MXU, and _hop_kernel / encounter_hop_pallas, the same per hop.
//
// What bounds it: the work is a product e[R, V] @ W[V, D]. Done densely it
// is R*V*D fp32 multiply-adds (71.6 GFLOP at M=256, D=546,484: 1.07 ms at
// 67 TFLOP/s outside the tensor cores) against 1.12 GB of bytes (W read
// once, mix written once: 0.33 ms at 3.35 TB/s), so a dense kernel is
// bound by operations. e is sparse in practice (a mule meets a few peers),
// so the least work the data needs is bytes-bound; skipping empty strips
// would reach for that and is later work. A ring hop (R = V = 64 at the
// same D) is bytes-bound even dense: 280 MB against 4.5 GFLOP.
//
// Design (simple and right first): a tiled fp32 matrix product whose left
// operand is generated on the fly.
// - Each block owns an output tile of kBM = 64 rows x kBN = 128 columns of
//   D; each of its 128 threads keeps an 8 x 8 register tile of sums.
// - The block walks the visiting mules in chunks of kKC = 32. Per chunk
//   it stages the chunk's geometry, builds the 0/1 strip e[rows, chunk] in
//   shared memory (one row per builder thread, which also counts the row's
//   mass), and stages W[chunk, tile] with coalesced loads. The ragged row,
//   visiting and D edges are masked, never padded.
// - Row blocks of one column tile have neighbouring block indices, so they
//   run together and read that tile of W from L2 rather than from memory.
// - Sums are fp32 fused multiply-adds in the order j = 0 .. V-1; with
//   e in {0, 1} each step adds W[j] exactly rounded. No atomics, so a
//   replay is bitwise equal.
// - The gate is the plain version's bit for bit: d2 is
//   __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) (no contraction into a
//   fused multiply-add), r2 arrives already rounded to float32, area is
//   compared as integers, and self-exclusion compares int64 global ids.
// - The mix's epilogue divides by fmaxf(mass, 1e-12f) with IEEE division
//   (no --use_fast_math) and stores in W's type; the hop's stores the sums
//   as they are. Column block 0 writes mass.
// - The launch allocates nothing and returns cudaGetLastError().
// TF32 and the tensor cores are not used: parity is fp32. wgmma, TMA and
// skipping empty strips are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kKC = 32;        // visiting mules per chunk
constexpr int kTX = 16;        // threads along the columns
constexpr int kTY = 8;         // threads along the rows
constexpr int kThreads = kTX * kTY;
constexpr int kTM = kBM / kTY;  // 8 rows per thread, consecutive
constexpr int kTN = kBN / kTX;  // 8 columns per thread, kTX apart
static_assert(kBN == kThreads, "one W column per thread when staging");
static_assert(kKC <= kThreads, "one chunk mule per thread when staging");
static_assert(kTM == 8, "two float4 reads of the strip per step");

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows [R] (global ids row_id0 + i) against visiting mules [V] (global ids
// col_id0 + j). kNormalize: the mix (divide by the mass, store in T); else
// the hop's unnormalised sums.
template <typename T, bool kNormalize>
__global__ void __launch_bounds__(kThreads)
    encounter_kernel(const float* __restrict__ pos_r,
                     const int64_t* __restrict__ area_r,
                     const uint8_t* __restrict__ active_r, int R,
                     int64_t row_id0, const float* __restrict__ pos_v,
                     const int64_t* __restrict__ area_v,
                     const uint8_t* __restrict__ active_v, int V,
                     int64_t col_id0, const T* __restrict__ W,
                     T* __restrict__ out, float* __restrict__ mass_out,
                     int64_t D, int n_row_blocks, float r2) {
  __shared__ __align__(16) float sE[kKC][kBM];  // sE[k][r] = e[r0+r, k0+k]
  __shared__ float sW[kKC][kBN];                // sW[k][c] = W[k0+k, c0+c]
  __shared__ float sX[kKC], sY[kKC];            // the chunk's geometry
  __shared__ int64_t sA[kKC];
  __shared__ int sOn[kKC];
  __shared__ float sMass[kBM];

  const int rb = (int)(blockIdx.x % (unsigned)n_row_blocks);
  const int64_t cb = blockIdx.x / (unsigned)n_row_blocks;
  const int r0 = rb * kBM;         // the tile's first row
  const int64_t c0 = cb * kBN;     // the tile's first column of D
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;

  // builder threads (tid < kBM) own row r0 + tid of the strip
  const int my_row = r0 + tid;
  const int64_t my_id = row_id0 + my_row;
  const bool builder = tid < kBM;
  float rx = 0.f, ry = 0.f;
  int64_t ra = 0;
  bool r_on = false;
  if (builder && my_row < R) {
    rx = pos_r[2 * (int64_t)my_row];
    ry = pos_r[2 * (int64_t)my_row + 1];
    ra = area_r[my_row];
    r_on = active_r[my_row] != 0;
  }
  float my_mass = 0.f;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int64_t my_col = c0 + tid;  // the column this thread stages
  for (int k0 = 0; k0 < V; k0 += kKC) {
    __syncthreads();  // every thread is done with the previous chunk
    if (tid < kKC) {
      const int c = k0 + tid;
      const bool in = c < V;
      sX[tid] = in ? pos_v[2 * (int64_t)c] : 0.f;
      sY[tid] = in ? pos_v[2 * (int64_t)c + 1] : 0.f;
      sA[tid] = in ? area_v[c] : 0;
      sOn[tid] = in && active_v[c] != 0;  // the ragged V edge is never met
    }
    // W[chunk, tile]: consecutive threads read consecutive columns
#pragma unroll 8
    for (int k = 0; k < kKC; ++k) {
      const int c = k0 + k;
      sW[k][tid] = (c < V && my_col < D)
                       ? load_f32(W + (int64_t)c * D + my_col)
                       : 0.f;
    }
    __syncthreads();
    if (builder) {
      // the chunk lane that is this row itself, if any: one int64 test
      // per chunk keeps the per-pair test in 32 bits
      const int64_t rel = my_id - (col_id0 + k0);
      const int self_k = (rel >= 0 && rel < kKC) ? (int)rel : -1;
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        const float dx = __fsub_rn(rx, sX[k]);
        const float dy = __fsub_rn(ry, sY[k]);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const bool met = r_on && sOn[k] && d2 <= r2 && ra == sA[k] &&
                         k != self_k;
        const float e = met ? 1.f : 0.f;
        sE[k][tid] = e;
        my_mass += e;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kKC; ++k) {
      const float4 e_lo = *reinterpret_cast<const float4*>(&sE[k][ty * kTM]);
      const float4 e_hi =
          *reinterpret_cast<const float4*>(&sE[k][ty * kTM + 4]);
      const float e[kTM] = {e_lo.x, e_lo.y, e_lo.z, e_lo.w,
                            e_hi.x, e_hi.y, e_hi.z, e_hi.w};
      float w[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) w[j] = sW[k][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(e[i], w[j], acc[i][j]);
    }
  }

  if (builder) {
    sMass[tid] = my_mass;
    if (cb == 0 && my_row < R) mass_out[my_row] = my_mass;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + ty * kTM + i;
    if (r >= R) break;
    const float den = kNormalize ? fmaxf(sMass[ty * kTM + i], 1e-12f) : 1.f;
    T* o = out + (int64_t)r * D;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t col = c0 + tx + kTX * j;
      if (col < D)
        store_f32(o + col, kNormalize ? acc[i][j] / den : acc[i][j]);
    }
  }
}

template <typename T, bool kNormalize>
int launch(const void* pos_r, const void* area_r, const void* active_r, int R,
           long long row_id0, const void* pos_v, const void* area_v,
           const void* active_v, int V, long long col_id0, const void* W,
           void* out, void* mass, long long D, float r2, void* stream) {
  if (R < 1 || V < 0 || D < 0) return (int)cudaErrorInvalidValue;
  const int n_row_blocks = (R + kBM - 1) / kBM;
  // at least one column block, so that mass is written when D == 0
  const long long n_col_blocks = D > 0 ? (D + kBN - 1) / kBN : 1;
  const long long n_blocks = n_row_blocks * n_col_blocks;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  encounter_kernel<T, kNormalize><<<(unsigned)n_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(pos_r), static_cast<const int64_t*>(area_r),
      static_cast<const uint8_t*>(active_r), R, (int64_t)row_id0,
      static_cast<const float*>(pos_v), static_cast<const int64_t*>(area_v),
      static_cast<const uint8_t*>(active_v), V, (int64_t)col_id0,
      static_cast<const T*>(W), static_cast<T*>(out),
      static_cast<float*>(mass), (int64_t)D, n_row_blocks, r2);
  return (int)cudaGetLastError();
}

// the mix: the population is both the rows and the visiting block
template <typename T>
int launch_mix(const void* pos, const void* area, const void* active,
               const void* W, void* out, void* mass, int M, long long D,
               float r2, void* stream) {
  return launch<T, true>(pos, area, active, M, 0, pos, area, active, M, 0, W,
                         out, mass, D, r2, stream);
}

}  // namespace

extern "C" int encounter_mix_f32(const void* pos, const void* area,
                                 const void* active, const void* W, void* out,
                                 void* mass, int M, long long D, float r2,
                                 void* stream) {
  return launch_mix<float>(pos, area, active, W, out, mass, M, D, r2, stream);
}

extern "C" int encounter_mix_bf16(const void* pos, const void* area,
                                  const void* active, const void* W,
                                  void* out, void* mass, int M, long long D,
                                  float r2, void* stream) {
  return launch_mix<__nv_bfloat16>(pos, area, active, W, out, mass, M, D, r2,
                                   stream);
}

// one ring hop: rows [R] with global ids row0 + i against a visiting block
// [V] with global ids col0 + j -> acc [R, D] f32 and mass [R] f32, both
// unnormalised
extern "C" int encounter_hop_f32(const void* pos_r, const void* area_r,
                                 const void* active_r, int R, long long row0,
                                 const void* pos_v, const void* area_v,
                                 const void* active_v, int V, long long col0,
                                 const void* W_v, void* acc, void* mass,
                                 long long D, float r2, void* stream) {
  return launch<float, false>(pos_r, area_r, active_r, R, row0, pos_v,
                              area_v, active_v, V, col0, W_v, acc, mass, D,
                              r2, stream);
}
