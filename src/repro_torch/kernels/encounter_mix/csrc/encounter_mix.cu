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
// The hop (encounter_hop_lanes_f32) is the same code with rows and visiting
// mules apart: local rows [R] (pos_r, area_r, active_r, global ids row0 +
// i) against a visiting block [V] (pos_v, area_v, active_v, global ids
// col0 + j, weights W_v [V, D] f32). It writes the unnormalised partials acc
// [R, D] = e @ W_v and mass [R] in f32, which the ring sums over its hops
// and normalises once. Global ids are int64 (the JAX kernel carries them as
// float32, exact only below 2^24 rows).
//
// Lanes (encounter_mix_lanes_*): a seed sweep's S populations in one call,
// pos [S, M, 2], area [S, M], active [S, M], W [S, M, D] -> mix [S, M, D],
// mass [S, M], scratch words [S, M, ceil(M / 32)]. The pairs kernel takes
// the lane as gridDim.y, offsetting every pointer by its lane's strides.
// The sums kernel's work items are (lane, row block, slab): the lane is
// gridDim.y, and each lane gets the whole persistent wave of a single call,
// so the lanes run one after another on the whole card (a lane's blocks
// start as the previous lane's retire), without a launch between them.
// W's tensor map is 3-d (D, M, S) with a box one lane deep. Each lane's
// pairs, dense switches and sums are those of a single-lane call on its
// inputs, so lane s has that call's bits. The hop has the same lanes: a
// sweep over the ranks sends each hop's lane-stacked block once and sums
// all its lanes in one call, and a single hop is its call with S = 1.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/encounter_mix/
// kernel.py: _mix_kernel / encounter_mix_pallas, which builds one
// [block_m, M] strip of e per (row block, d block) tile and multiplies it
// on the MXU, and _hop_kernel / encounter_hop_pallas, the same per hop.
//
// What bounds it: bytes. The product e[R, V] @ W[V, D] needs one add per
// met pair and column; at the peer path's first exchange (M = 256, D =
// 546,484, 1,784 met pairs of 65,280) that is 1.95 GFLOP, 0.03 ms at 67
// TFLOP/s, against 1.12 GB of bytes (W read once, mix written once: 0.33
// ms at 3.35 TB/s). A ring hop (R = V = 64) moves 280 MB (0.084 ms). Done
// densely the mix would be 71.6 GFLOP (1.07 ms): a dense kernel is shaped
// as if bound by operations, and 97% of its multiply-adds are by zero.
//
// Design: work per met pair, W moved once. Two launches a call.
// 1. encounter_pairs_kernel, one warp per row: the gate for 32 visiting
//    mules at a time, __ballot_sync into one 32-bit word of the row's meet
//    mask (bit b of word w is visiting mule 32 w + b), so the set bits list
//    the met j in ascending order; mass[i] is the popcount. The words go to
//    scratch the wrapper allocates ([R, ceil(V / 32)] int32, 8 KB at the
//    walk): the gate is computed once per call, not once per column tile.
// 2. encounter_sum_kernel, persistent: a block owns a fixed block of rows
//    (Shape: kWarps warps of kRW rows) and walks column slabs of kC = 128
//    columns of D, slab b / n_row_blocks + i * (grid / n_row_blocks); the
//    row blocks of one slab have neighbouring block indices, so a slab
//    leaves device memory once and its other readers find it in L2. A slab
//    is walked in chunks of 32 visiting mules (one mask word).
//    - W[chunk, slab] comes into shared memory kStages deep, the stream of
//      (slab, chunk) running on across slabs: by one TMA copy of the
//      [32, 128] box on an mbarrier where W's rows are 16-byte aligned
//      (f32 with D % 4 == 0, the walk and the hop); else by cp.async in 8-
//      or 4-byte granules (bf16 at D = 546,484, f32 at an odd D); else (bf16
//      at an odd D) by plain loads, the edge inside the same kernel. Each
//      fills rows past V and columns past D with zeros.
//    - Lane l owns columns 4 l .. 4 l + 3 of the slab and keeps kRW x 4 fp32
//      sums in registers. Per chunk a warp counts its strip's pairs (kRW
//      rows x 32 mules) and picks a mode. Sparse, under dense_min pairs a
//      row: for each row, each set bit in ascending order, W[j, cols] added
//      from shared memory (two loads in flight). Dense: the strip's bits as
//      0/1 floats in shared memory and a register-tiled loop, each W value
//      loaded once for the warp's kRW rows, fmaf(e, w, acc). With e in
//      {0, 1} both add the same W rows in ascending j, one rounding a term,
//      from +0, into the same sums: the two modes give the same bits, the
//      bits of the dense kernel this replaces (fmaf over j = 0 .. V-1), on
//      finite weights. The choice is a speed trade, never a fallback;
//      dense_min comes from the wrapper (0: every strip dense; 33: none).
//    - A hop's sums kernel is launched early (programmatic dependent
//      launch): its blocks start their first copies while the pairs kernel
//      runs and wait for it (griddepcontrol.wait) before reading its words.
//    - The epilogue divides by mass with IEEE division (no
//      --use_fast_math) where mass > 0; a row with no pair keeps its +0
//      sums, which is what dividing by fmaxf(mass, 1e-12f) gives, without
//      the division's slow path. It stores in W's type, 4 columns a lane
//      (16 bytes in f32, 8 in bf16) where D % 4 == 0, else one by one; the
//      hop stores its sums as they are. Ragged R, V and D are masked.
// - The gate is the plain version's bit for bit: d2 is
//   __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) (no contraction into a
//   fused multiply-add), r2 arrives already rounded to float32, area is
//   compared as integers, and self-exclusion compares global ids.
// - No atomics, so a replay is bitwise equal. The launches allocate nothing
//   and return cudaGetLastError(); shared memory above 48 KB is set here.
//   cuTensorMapEncodeTiled comes through the runtime's entry-point query,
//   so the library links only cudart.
// The tensor cores are not used: the mix is held to fp32 at 1e-5, TF32
// keeps about three digits, and the work the data needs is tiny; in the
// dense regime (the trace scenarios' pos = 0, e about half full) the FP32
// FMAs of the dense mode do it. A 3xTF32 wgmma path is later work.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kPairWarps = 8;  // rows a block of the pairs kernel
constexpr int kKC = 32;        // visiting mules per chunk: one mask word
constexpr int kC = 128;        // columns of D per slab
constexpr int kVec = 4;        // columns per lane
static_assert(kC == 32 * kVec, "one warp spans a slab");

// The sums kernel's shape: kWarps warps of kRW rows each, kStages chunks of
// W in shared memory, kBlocks blocks resident on an SM; kEarly: launched
// while the pairs kernel runs (programmatic dependent launch).
template <int kWarps_, int kRW_, int kStages_, int kBlocks_, bool kEarly_>
struct Shape {
  static constexpr int kWarps = kWarps_, kRW = kRW_, kStages = kStages_;
  static constexpr int kBlocks = kBlocks_, kThreads = 32 * kWarps_;
  static constexpr bool kEarly = kEarly_;
  template <typename T>
  static constexpr int smem_bytes() {
    return 128 + kStages * kKC * kC * (int)sizeof(T) + kWarps * kKC * kRW * 4;
  }
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// 4 consecutive values; p aligned to 4 elements
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const uint32_t*>(&a);
  x.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// The one arrival of a phase, which also tells the barrier how many bytes
// its TMA copy brings.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of the given parity has completed; a copy that
// never lands traps after ~4M tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 22)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// the [kKC, kC] box of the 2-d tensor map at column c0, row r0 into dst,
// completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(r0)
      : "memory");
}

// the [1, kKC, kC] box of the 3-d tensor map at column c0, row r0 of lane
// s into dst, completing on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int r0,
                                            int s) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(r0),
      "r"(s)
      : "memory");
}

// cp.async of N bytes (src_bytes of them read, the rest zero-filled)
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
               "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One warp per row i: words[i, w] bit b = e[i, 32 w + b]; mass[i] = its
// popcount. Rows [R] (global ids row_id0 + i) against visiting mules [V]
// (global ids col_id0 + j); a null activity pointer means all active.
// kLanes: the lane is blockIdx.y and every pointer is offset by its strides.
template <bool kLanes>
__global__ void __launch_bounds__(32 * kPairWarps)
    encounter_pairs_kernel(const float* __restrict__ pos_r,
                           const int64_t* __restrict__ area_r,
                           const uint8_t* __restrict__ active_r, int R,
                           int64_t row_id0, const float* __restrict__ pos_v,
                           const int64_t* __restrict__ area_v,
                           const uint8_t* __restrict__ active_v, int V,
                           int64_t col_id0, float r2,
                           uint32_t* __restrict__ words, int nw,
                           float* __restrict__ mass) {
  // the sums kernel may start now: it reads the words only after this
  // grid has finished (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (kLanes) {  // the lane: offset every pointer
    const int64_t s = blockIdx.y;
    pos_r += s * 2 * R, area_r += s * R, pos_v += s * 2 * V, area_v += s * V;
    if (active_r != nullptr) active_r += s * R;
    if (active_v != nullptr) active_v += s * V;
    words += s * R * nw, mass += s * R;
  }
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kPairWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp
  const float rx = pos_r[2 * (int64_t)row], ry = pos_r[2 * (int64_t)row + 1];
  const int64_t ra = area_r[row];
  const bool r_on = active_r == nullptr || active_r[row] != 0;
  // the visiting index that is this row itself, if in [0, V)
  const int64_t self = row_id0 + row - col_id0;
  int count = 0;
  for (int w = 0; w < nw; ++w) {
    const int j = w * 32 + lane;
    bool met = false;
    if (r_on && j < V) {
      const float dx = __fsub_rn(rx, pos_v[2 * (int64_t)j]);
      const float dy = __fsub_rn(ry, pos_v[2 * (int64_t)j + 1]);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      met = (active_v == nullptr || active_v[j] != 0) && d2 <= r2 &&
            ra == area_v[j] && (int64_t)j != self;
    }
    const uint32_t b = __ballot_sync(0xffffffffu, met);
    if (lane == 0) words[(int64_t)row * nw + w] = b;
    count += __popc(b);
  }
  if (lane == 0) mass[row] = (float)count;
}

// How W's chunks reach shared memory: a TMA copy of the [32, 128] box
// where W's rows are 16-byte aligned; else cp.async in the largest granule
// (8 or 4 bytes) the rows' alignment allows; else (bf16 rows of an odd D)
// plain loads. All three fill out-of-range rows and columns with zeros.
enum Load { kLoadTma = 0, kLoadAsync = 1, kLoadSync = 2 };

// out[i, :] = sum of W[j, :] over the set bits j of row i's words, in
// ascending j; kNormalize: divided by max(mass[i], 1e-12) and stored in T
// (the mix), else stored as they are (the hop). vec_out: out's rows take
// 4-element stores (D % 4 == 0). kLanes: the lane is blockIdx.y, every
// pointer is offset by its strides and W comes through the 3-d map; a
// single call takes kLanes = false, whose pointers stay the kernel's
// parameters (offsetting them cost a single call ~7%, PERF.md).
template <typename T, bool kNormalize, class S, bool kLanes>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
    encounter_sum_kernel(const __grid_constant__ CUtensorMap tm,
                         const uint32_t* __restrict__ words, int nw,
                         const float* __restrict__ mass, int R, int V,
                         const T* __restrict__ W, T* __restrict__ out,
                         int64_t D, int n_row_blocks, int64_t n_slabs,
                         int dense_min, int load, int granule, int vec_out) {
  constexpr int kWarps = S::kWarps, kRW = S::kRW, kStages = S::kStages;
  constexpr int kThreads = S::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* sW = reinterpret_cast<T*>(smem + 128);  // [kStages][kKC][kC]
  float* sE = reinterpret_cast<float*>(      // [kWarps][kKC][kRW]
      smem + 128 + kStages * kKC * kC * sizeof(T));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;
  if (kLanes) {  // the lane (of a sweep): offset its pointers
    const int64_t ls = blockIdx.y;
    words += ls * R * nw, mass += ls * R, W += ls * V * D, out += ls * R * D;
  }
  const int rb = (int)(blockIdx.x % (unsigned)n_row_blocks);
  const int64_t slab0 = blockIdx.x / (unsigned)n_row_blocks;
  const int64_t slab_step = gridDim.x / (unsigned)n_row_blocks;
  const int n_chunks = nw;
  const int64_t n_mine =
      slab0 < n_slabs ? (n_slabs - 1 - slab0) / slab_step + 1 : 0;
  const int64_t n_iter = n_mine * n_chunks;  // (slab, chunk) steps

  const int row0 = (rb * kWarps + warp) * kRW;  // this warp's first row
  const bool row_in = lane < kRW && row0 + lane < R;  // lane's row
  const uint32_t* my_words =
      words + (int64_t)(row_in ? row0 + lane : 0) * nw;
  float* se = sE + warp * kKC * kRW;  // this warp's strip: se[k * kRW + r]

  // the producer's cursor: chunk p_c of slab p_slab into stage p_s
  int64_t p_t = 0, p_slab = slab0;
  int p_c = 0, p_s = 0;
  auto produce = [&]() {
    const int k0 = p_c * kKC;
    const int64_t c0 = p_slab * kC;
    T* dst = sW + (int64_t)p_s * kKC * kC;
    if (load == kLoadTma) {
      if (tid == 0 && p_t < n_iter) {
        const uint32_t bar = smem_addr(&bars[p_s]);
        mbar_expect(bar, kKC * kC * sizeof(T));
        if (kLanes)
          tma_load_3d(smem_addr(dst), &tm, bar, (int)c0, k0, blockIdx.y);
        else
          tma_load_2d(smem_addr(dst), &tm, bar, (int)c0, k0);
      }
    } else {  // kLoadAsync: one group a chunk, empty past the last
      if (p_t < n_iter) {
        const int per_row = kC * (int)sizeof(T) / granule;  // granules
        const int elems = granule / (int)sizeof(T);
        for (int g = tid; g < kKC * per_row; g += kThreads) {
          const int k = g / per_row, e = (g % per_row) * elems;
          const bool in = k0 + k < V && c0 + e < D;
          const T* src = in ? W + (int64_t)(k0 + k) * D + c0 + e : W;
          const uint32_t d = smem_addr(dst + k * kC + e);
          const int n = in ? granule : 0;
          if (granule == 8)
            cp_async<8>(d, src, n);
          else
            cp_async<4>(d, src, n);
        }
      }
      cp_commit();
    }
    ++p_t;
    if (++p_c == n_chunks) p_c = 0, p_slab += slab_step;
    if (++p_s == kStages) p_s = 0;
  };

  if (load == kLoadTma) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&bars[s]));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  if (load != kLoadSync)
    for (int i = 0; i < kStages - 1; ++i) produce();
  // W's first chunks are on their way; the words and masses are the pairs
  // kernel's (a no-op unless this grid was launched early)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // a row with no pair has sums of +0 (or NaN from a non-finite weight in a
  // dense strip), which the division by 1e-12 leaves as they are
  float den = 1.f;
  if (kNormalize && row_in) den = mass[row0 + lane];

  float acc[kRW][kVec];
#pragma unroll
  for (int r = 0; r < kRW; ++r)
#pragma unroll
    for (int x = 0; x < kVec; ++x) acc[r][x] = 0.f;
  uint32_t word = (n_iter > 0 && row_in) ? my_words[0] : 0u;
  int64_t slab = slab0;
  int c = 0, s = 0;
  uint32_t phase = 0;

  for (int64_t t = 0; t < n_iter; ++t) {
    const int k0 = c * kKC;
    const int kn = min(kKC, V - k0);  // the chunk's visiting mules
    if (load == kLoadAsync) {
      cp_wait<kStages - 2>();  // this thread's copies of chunk t landed
      __syncthreads();         // everyone's, and chunk t-1 is summed
      produce();               // chunk t + kStages - 1, into t-1's stage
    } else if (load == kLoadTma) {
      __syncthreads();  // chunk t-1 is summed: its stage is free
      produce();
      mbar_wait(smem_addr(&bars[s]), phase);
    } else {
      __syncthreads();
      for (int e = tid; e < kKC * kC; e += kThreads) {
        const int k = e / kC;
        const int64_t col = slab * kC + e % kC;
        store_f32(sW + e, k0 + k < V && col < D
                              ? load_f32(W + (int64_t)(k0 + k) * D + col)
                              : 0.f);
      }
      __syncthreads();
    }
    const int c_next = c + 1 == n_chunks ? 0 : c + 1;
    const uint32_t next = (t + 1 < n_iter && row_in) ? my_words[c_next] : 0u;
    const T* st = sW + (load == kLoadSync ? 0 : s * kKC * kC) + lane * kVec;

    const int pairs = (int)__reduce_add_sync(full, (unsigned)__popc(word));
    if (pairs >= dense_min * kRW) {
      // dense: the strip as 0/1 floats, each W value used for kRW rows
      if (lane < kRW) {
#pragma unroll
        for (int k = 0; k < kKC; ++k)
          se[k * kRW + lane] = ((word >> k) & 1u) ? 1.f : 0.f;
      }
      __syncwarp();
      for (int k = 0; k < kn; ++k) {
        float w[kVec];
        load4(st + k * kC, w);
#pragma unroll
        for (int r = 0; r < kRW; r += 4) {
          const float4 e4 =
              *reinterpret_cast<const float4*>(se + k * kRW + r);
          const float e[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              acc[r + q][x] = fmaf(e[q], w[x], acc[r + q][x]);
        }
      }
      __syncwarp();  // the strip is read before the next chunk rewrites it
    } else {
      // sparse: the set bits of each row, ascending, two loads in flight
      unsigned rows[kRW];  // every row's word, in every lane
#pragma unroll
      for (int r = 0; r < kRW; ++r) rows[r] = __shfl_sync(full, word, r);
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        unsigned m = rows[r];
        while (m) {
          const int k1 = __ffs(m) - 1;
          m &= m - 1;
          float w1[kVec];
          load4(st + k1 * kC, w1);
          if (m) {
            const int k2 = __ffs(m) - 1;
            m &= m - 1;
            float w2[kVec];
            load4(st + k2 * kC, w2);
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              acc[r][x] = __fadd_rn(__fadd_rn(acc[r][x], w1[x]), w2[x]);
          } else {
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              acc[r][x] = __fadd_rn(acc[r][x], w1[x]);
          }
        }
      }
    }

    if (c == n_chunks - 1) {  // the slab is summed: store and start over
      const int64_t col = slab * kC + lane * kVec;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float m = __shfl_sync(full, den, r);
        if (row0 + r < R) {
          float v[kVec];
#pragma unroll
          for (int x = 0; x < kVec; ++x)
            v[x] = kNormalize && m > 0.f ? acc[r][x] / m : acc[r][x];
          T* o = out + (int64_t)(row0 + r) * D + col;
          if (vec_out && col + kVec <= D) {
            store4(o, v);
          } else {
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              if (col + x < D) store_f32(o + x, v[x]);
          }
        }
#pragma unroll
        for (int x = 0; x < kVec; ++x) acc[r][x] = 0.f;
      }
    }
    word = next;
    if (++c == n_chunks) c = 0, slab += slab_step;
    if (++s == kStages) s = 0, phase ^= 1u;
  }
  if (load == kLoadAsync) cp_wait<0>();  // no copy outlives the block
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a CUDA driver API call, through the runtime, so
// that the library links only cudart
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

constexpr int kErrEncode = 10000;  // + the encode's CUresult

// W [S, V, D] as a 3-d tensor map (D, V, S) whose box is one lane of kKC
// rows x kC columns, or for one lane the 2-d map (D, V) of its [kKC, kC]
// box; out-of-range elements read as zeros
template <typename T>
int encode_w(CUtensorMap* map, const void* W, int S, int V, long long D) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrEncode;
  const cuuint32_t rank = S == 1 ? 2 : 3;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)V, (cuuint64_t)S};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)V * D * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)kC, (cuuint32_t)kKC, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res =
      fn(map,
         sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         rank, const_cast<void*>(W), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + (int)res;
}

template <typename T, bool kNormalize, class S, bool kLanes>
int launch_sums(int lanes, const void* words, const void* mass, int R, int V,
                const void* W, void* out, long long D, int dense_min,
                cudaStream_t s) {
  auto kern = encounter_sum_kernel<T, kNormalize, S, kLanes>;
  constexpr int bytes = S::template smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                      S::kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = S::kWarps * S::kRW;
  const int n_row_blocks = (R + rows_per_block - 1) / rows_per_block;
  const long long n_slabs = (D + kC - 1) / kC;
  // one wave of resident blocks for each lane, a whole number of row blocks
  // a slab
  long long slab_blocks = (long long)sms * occ / n_row_blocks;
  if (slab_blocks < 1) slab_blocks = 1;
  if (slab_blocks > n_slabs) slab_blocks = n_slabs;
  const int nw = V > 0 ? (V + 31) / 32 : 1;

  // the widest copy the rows' alignment allows (a tensor map needs V > 0)
  const uintptr_t w_addr = reinterpret_cast<uintptr_t>(W);
  const long long pitch = D * (long long)sizeof(T);
  int load = kLoadSync, granule = 0;
  CUtensorMap tm;
  memset(&tm, 0, sizeof(tm));
  if (pitch % 16 == 0 && w_addr % 16 == 0 && V > 0) {
    const int e = encode_w<T>(&tm, W, lanes, V, D);
    if (e != 0) return e;
    load = kLoadTma;
  } else {
    for (int g = 8; g >= 4 && load == kLoadSync; g /= 2)
      if (pitch % g == 0 && w_addr % g == 0) load = kLoadAsync, granule = g;
  }
  const uintptr_t o_addr = reinterpret_cast<uintptr_t>(out);
  const int vec_out = D % kVec == 0 && o_addr % (kVec * sizeof(T)) == 0;
  // kEarly, a programmatic dependent launch: the blocks start while the
  // pairs kernel runs, and wait for it only before they read its words
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_row_blocks * slab_blocks), (unsigned)lanes);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S::kEarly ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kern, tm, static_cast<const uint32_t*>(words), nw,
      static_cast<const float*>(mass), R, V, static_cast<const T*>(W),
      static_cast<T*>(out), (int64_t)D, n_row_blocks, (int64_t)n_slabs,
      dense_min, load, granule, vec_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_pairs(int lanes, const void* pos_r, const void* area_r,
                 const void* active_r, int R, long long row_id0,
                 const void* pos_v, const void* area_v, const void* active_v,
                 int V, long long col_id0, float r2, void* words, void* mass,
                 cudaStream_t s) {
  const int nw = V > 0 ? (V + 31) / 32 : 1;
  const dim3 grid((unsigned)((R + kPairWarps - 1) / kPairWarps),
                  (unsigned)lanes);
  auto kern = lanes > 1 ? encounter_pairs_kernel<true>
                        : encounter_pairs_kernel<false>;
  kern<<<grid, 32 * kPairWarps, 0, s>>>(
      static_cast<const float*>(pos_r), static_cast<const int64_t*>(area_r),
      static_cast<const uint8_t*>(active_r), R, (int64_t)row_id0,
      static_cast<const float*>(pos_v), static_cast<const int64_t*>(area_v),
      static_cast<const uint8_t*>(active_v), V, (int64_t)col_id0, r2,
      static_cast<uint32_t*>(words), nw, static_cast<float*>(mass));
  return (int)cudaGetLastError();
}

// Picked from exploratory timings on an H100 (PERF.md): the mix
// takes 128 rows a block of 16 warps, two blocks an SM; a hop of at most 64
// rows, 4 warps of 16 rows, four blocks an SM with 3 chunks of W each. The
// early launch sped the hop up and slowed the mix, so only the hop takes
// it.
using BigShape = Shape<16, 8, 4, 2, false>;
using SmallShape = Shape<4, 16, 3, 4, true>;

// Rows [R] against visiting mules [V], in each of `lanes` lanes: the pairs,
// then the sums.
template <typename T, bool kNormalize>
int launch(int lanes, const void* pos_r, const void* area_r,
           const void* active_r, int R, long long row_id0, const void* pos_v,
           const void* area_v, const void* active_v, int V, long long col_id0,
           const void* W, void* out, void* mass, void* words, long long D,
           float r2, int dense_min, void* stream) {
  if (lanes < 1 || lanes > 65535 || R < 1 || V < 0 || D < 0 || dense_min < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_pairs(lanes, pos_r, area_r, active_r, R, row_id0, pos_v,
                         area_v, active_v, V, col_id0, r2, words, mass, s);
  if (err != 0 || D == 0) return err;
  if (lanes > 1)
    return R <= 64 ? launch_sums<T, kNormalize, SmallShape, true>(
                         lanes, words, mass, R, V, W, out, D, dense_min, s)
                   : launch_sums<T, kNormalize, BigShape, true>(
                         lanes, words, mass, R, V, W, out, D, dense_min, s);
  return R <= 64 ? launch_sums<T, kNormalize, SmallShape, false>(
                       1, words, mass, R, V, W, out, D, dense_min, s)
                 : launch_sums<T, kNormalize, BigShape, false>(
                       1, words, mass, R, V, W, out, D, dense_min, s);
}

}  // namespace

// the mix: the population is both the rows and the visiting block; words
// is scratch of [M, ceil(M / 32)] int32 (at least one word a row). The
// wrappers call the lanes entries below (one lane for a single call); these
// two keep the single-call interface that tools/ab_encounter_mix.py calls
// on a source built from another commit.
extern "C" int encounter_mix_f32(const void* pos, const void* area,
                                 const void* active, const void* W, void* out,
                                 void* mass, void* words, int M, long long D,
                                 float r2, int dense_min, void* stream) {
  return launch<float, true>(1, pos, area, active, M, 0, pos, area, active, M,
                             0, W, out, mass, words, D, r2, dense_min, stream);
}

extern "C" int encounter_mix_bf16(const void* pos, const void* area,
                                  const void* active, const void* W,
                                  void* out, void* mass, void* words, int M,
                                  long long D, float r2, int dense_min,
                                  void* stream) {
  return launch<__nv_bfloat16, true>(1, pos, area, active, M, 0, pos, area,
                                     active, M, 0, W, out, mass, words, D, r2,
                                     dense_min, stream);
}

// S lanes of the mix in one call: pos [S, M, 2], area [S, M], active [S, M]
// (or null), W [S, M, D] -> out [S, M, D], mass [S, M]; words is scratch of
// [S, M, ceil(M / 32)] int32
extern "C" int encounter_mix_lanes_f32(const void* pos, const void* area,
                                       const void* active, const void* W,
                                       void* out, void* mass, void* words,
                                       int S, int M, long long D, float r2,
                                       int dense_min, void* stream) {
  return launch<float, true>(S, pos, area, active, M, 0, pos, area, active, M,
                             0, W, out, mass, words, D, r2, dense_min, stream);
}

extern "C" int encounter_mix_lanes_bf16(const void* pos, const void* area,
                                        const void* active, const void* W,
                                        void* out, void* mass, void* words,
                                        int S, int M, long long D, float r2,
                                        int dense_min, void* stream) {
  return launch<__nv_bfloat16, true>(S, pos, area, active, M, 0, pos, area,
                                     active, M, 0, W, out, mass, words, D, r2,
                                     dense_min, stream);
}

// S lanes of one ring hop in one call (a seed sweep over the ranks): pos_r
// [S, R, 2], area_r [S, R], active_r [S, R] (or null), pos_v [S, V, 2],
// area_v [S, V], active_v [S, V] (or null), W_v [S, V, D] -> acc [S, R, D],
// mass [S, R]; words is scratch of [S, R, ceil(V / 32)] int32. Every lane
// shares row0 and col0 (one rank's blocks). The lane is gridDim.y of both
// kernels, as in encounter_mix_lanes_*.
extern "C" int encounter_hop_lanes_f32(
    const void* pos_r, const void* area_r, const void* active_r, int R,
    long long row0, const void* pos_v, const void* area_v,
    const void* active_v, int V, long long col0, const void* W_v, void* acc,
    void* mass, void* words, int S, long long D, float r2, int dense_min,
    void* stream) {
  return launch<float, false>(S, pos_r, area_r, active_r, R, row0, pos_v,
                              area_v, active_v, V, col0, W_v, acc, mass,
                              words, D, r2, dense_min, stream);
}

// the pairs alone: words [R, ceil(V / 32)] int32 and mass [R] f32
extern "C" int encounter_pairs(const void* pos_r, const void* area_r,
                               const void* active_r, int R, long long row0,
                               const void* pos_v, const void* area_v,
                               const void* active_v, int V, long long col0,
                               float r2, void* words, void* mass,
                               void* stream) {
  if (R < 1 || V < 0) return (int)cudaErrorInvalidValue;
  return launch_pairs(1, pos_r, area_r, active_r, R, row0, pos_v, area_v,
                      active_v, V, col0, r2, words, mass,
                      static_cast<cudaStream_t>(stream));
}
