// K6 flash_attention, the split_kv route: a few query rows over many keys
// (a decode step's attention; seamless-m4t's cross-attention over the
// encoder's frames).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (:102)
// for calls of 64 query rows or fewer at the served head dims (64/64,
// 128/128, 192/128), in bf16 and f32 (kernels/flash_attention.py:
// flash_attention_route). The TPU kernel walks one (head, q block) grid
// row over the KV blocks in order, carrying its running max and sums in
// VMEM from one grid step to the next.
//
// What bounds it on the H100: bytes. One query row does 2 (d + dv) flops
// per key it reads d + dv elements of: at seamless's cut cross-attention
// decode (8 sequences x 1 row over 8192 frames, one head of 64, bf16)
// K and V are 8 x 8192 x 64 x 2 x 2 bytes = 16.8 MB, 5.0 us at 3.35 TB/s,
// against 0.07 us of bf16 tensor-core work. So what counts is how many
// blocks stream K and V at once, and that each key is read once. The
// mma_sync route (flash_attention.cu) runs such a call as one block per
// (sequence, q head), each walking every key tile alone with one real row
// in its 64: 8 blocks on 132 SMs.
//
// Design:
// - A block per (sequence, kv head, 64-row tile, key split). Its rows are
//   the GQA group's q heads times the call's query rows, packed query-
//   major (packed row r is query r / group of q head hk * group + r %
//   group, so a query's group rows are contiguous in q and the output),
//   16 to a warp, as many warps as the tile has 16-row parts (1-4: a
//   decode step's GQA group fills one warp's 16 rows or fewer); a call
//   with more than 64 packed rows adds 64-row tiles on grid.y. K
//   and V are read once per kv head, not once per q head: under GQA 8
//   (tinyllama's decode) that is an eighth of the mma_sync route's bytes.
// - The keys the call can see (the causal bound at q_offset + the last
//   row, the window's low edge at q_offset + the first row - window + 1,
//   tile-aligned down) are cut into `splits` runs of `keys_per_split`
//   keys, a whole number of 64-key tiles each: split_kv_plan in
//   kernels/flash_attention.py chooses them (the fewest tiles a split
//   with which the blocks still fit one wave, the blocks that
//   reconic_flash_attention_splitkv_wave says the card holds at once: a
//   second, partial wave left most SMs idle behind it; one split when
//   the keys fit in one tile: a block's tiles run one after another on
//   one warp, so two splits of one tile beat one of two, merge and all,
//   PERF.md §6), the launcher checks them. A block streams only the keys
//   of its split that some row of its tile can see.
// - K and V stream through a ring of 64-key stages filled by 16-byte
//   cp.async (2 or 3 stages, 37-86 KB a block at the bf16 and f32 d 64
//   and bf16 d 128 and 192/128 rings): zero-fill past Skv and the padded
//   rows that the mma.sync fragment loads want come free with per-thread
//   copies, where TMA would need a swizzled layout and a producer warp
//   for blocks of one to four warps. The ring is kept small so that 3-4
//   blocks share an SM: a decode step's block computes on one warp,
//   whose tile takes ~1200 cycles of dependent mma, shuffle and exp work
//   for 16 KB (bf16, d 64), so an SM needs 3 or more such warps at once
//   to pull its ~14.5 bytes a cycle of HBM's rate (two blocks an SM ran
//   1.2x slower at 32768 keys, PERF.md §6); they keep 96-128 KB of loads
//   in flight an SM, past the ~25 KB that covers HBM's latency. (Warps
//   that only load would cost the SM blocks: the registers of a thread
//   are the kernel's, ~220, whether its warp computes or not.)
// - The arithmetic is the mma_sync route's (flash_attention_mma.cuh): bf16
//   on m16n8k16 with P split as bf16(p) + bf16(p - hi); f32 as 3xTF32 on
//   m16n8k8 with each tile's PV in fresh accumulators; masked scores
//   -1e30 with an exact 0 weight; no fast math.
// - One split: the block normalises and writes the output (one launch, no
//   scratch). Several: each block writes its rows' unnormalised f32 O and
//   their m and l to a scratch the wrapper allocates
//   (reconic_flash_attention_splitkv_scratch_words), and a second kernel
//   merges the splits with log-sum-exp weights in split order, with no
//   atomics: two runs give the same bits. A split that sees no key of a
//   row has l = 0 and weighs 0; a row with no visible key writes 0.
#include <algorithm>
#include <climits>

#include "flash_attention_mma.cuh"

namespace {

using namespace reconic::mma_attention;
using reconic::cp_async_commit;
using reconic::cp_async_wait;

constexpr int kRows = 64;                 // packed rows a block, 16 a warp

// Stages of the K/V ring: 55.3 KB a block in bf16 at d 64 (four blocks an
// SM), 69.6 KB at 128 and 86 KB at 192/128 (three, two), 71.7 KB in f32
// at 64 (three); f32 at 128 and 192/128 take 146-221 KB with q staged
// (one).
template <typename T, int DQK, int DV>
struct Ring {
  using C = Cfg<T, DQK, DV>;
  static constexpr int kStages = C::kBF16 && DQK == 64 ? 3 : 2;
  static int smem_bytes(int warps) {
    return (kStages * (C::kKTile + C::kVTile) +
            (C::kQSmem ? 16 * warps * C::kKStride : 0)) *
           static_cast<int>(sizeof(T));
  }
};

// Warps of a block for a call with `rows` packed rows: one a 16-row part
// of a 64-row tile.
int block_warps(long long rows) {
  return static_cast<int>((std::min<long long>(rows, kRows) + 15) / 16);
}

// Lets `kern` take `smem` bytes of dynamic shared memory.
template <typename K>
int allow_smem(K kern, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// The first key tile of the call's visible range: keys before it are
// outside every row's window.
__host__ __device__ __forceinline__ int range_lo(int qoff, int window) {
  const int edge = qoff - window + 1;
  return window > 0 && edge > 0 ? edge / kBK * kBK : 0;
}

// grid (batch * hkv, ceil(group * sq / 64), splits), 32 x block_warps
// threads.
// part and ml: the scratch (several splits only), row-major over output
// rows (b, query, q head), then split: O in f32 (DV words) and (m, l).
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(128)
    flash_attention_splitkv_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   T* __restrict__ o, float* __restrict__ part,
                                   float* __restrict__ ml, int hq, int hkv,
                                   int sq, int skv, int causal, int window,
                                   int qoff, float scale, int splits,
                                   int keys_per_split) {
  using C = Cfg<T, DQK, DV>;
  using R = Ring<T, DQK, DV>;
  constexpr int kDT = C::kDT;
  constexpr int kStages = R::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);        // [kStages][kBK][kKStride]
  T* vs = ks + kStages * C::kKTile;               // [kStages][kBK][kVStride]
  T* qs = vs + kStages * C::kVTile;               // [16 * warps][kKStride]

  const int nthreads = blockDim.x;
  const int group = hq / hkv;
  const int rows = group * sq;
  const int b = blockIdx.x / hkv;
  const int hk = blockIdx.x % hkv;
  const int t0 = blockIdx.y * kRows;      // the tile's first packed row
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = t0 + warp * 16 + g;      // this lane's rows r0, r0 + 8
  const size_t k_row = static_cast<size_t>(hkv) * DQK;
  const size_t v_row = static_cast<size_t>(hkv) * DV;
  const T* kb = k + static_cast<size_t>(b) * skv * k_row + hk * DQK;
  const T* vb = v + static_cast<size_t>(b) * skv * v_row + hk * DV;
  // packed row r: query r / group of q head hk * group + r % group; its
  // output row (b, query, head) in rows of hq heads
  auto out_row = [&](int r) -> size_t {
    return (static_cast<size_t>(b) * sq + r / group) * hq + hk * group +
           r % group;
  };
  const bool live0 = r0 < rows;
  const bool live1 = r0 + 8 < rows;

  // the keys some row of this tile can see, within this split's run
  const int last = min(t0 + kRows, rows) - 1;
  const int pf = qoff + t0 / group;       // the tile's first position
  const int pl = qoff + last / group;     // and its last
  const int lo = range_lo(qoff, window) + split * keys_per_split;
  const int k_begin = max(lo, range_lo(pf, window));
  const int k_end = min(lo + keys_per_split, causal ? min(skv, pl + 1) : skv);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK
                                      : 0;
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles)
      load_tile<T, DQK, DV, 0>(ks + i * C::kKTile, vs + i * C::kVTile, kb,
                               vb, k_row, v_row, k_begin + i * kBK, skv,
                               nthreads);
    else
      cp_async_commit();                  // an empty group keeps the count
  }

  uint32_t qa[C::kQSmem ? 1 : C::kQK][4];
  uint32_t qlo[C::kBF16 || C::kQSmem ? 1 : C::kQK][4];
  if constexpr (C::kQSmem)
    stage_q<T, DQK, DV, 0>(
        qs, 16 * (nthreads / 32),
        [&](int rr) -> const T* {
          return t0 + rr < rows ? q + out_row(t0 + rr) * DQK : nullptr;
        },
        scale, nthreads);
  else
    load_q<T, DQK, DV>(qa, qlo, q + out_row(live0 ? r0 : 0) * DQK,
                       q + out_row(live1 ? r0 + 8 : 0) * DQK, live0, live1,
                       scale, t);
  const int qpos[2] = {qoff + r0 / group, qoff + (r0 + 8) / group};
  // a warp whose rows all lie past the call loads its share and computes
  // nothing
  const bool warp_live = t0 + warp * 16 < rows;

  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();         // tile it has landed
    __syncthreads();                      // and tile it - 1 is consumed
    const int nxt = it + kStages - 1;
    if (nxt < n_tiles)
      load_tile<T, DQK, DV, 0>(ks + (nxt % kStages) * C::kKTile,
                               vs + (nxt % kStages) * C::kVTile, kb, vb,
                               k_row, v_row, k_begin + nxt * kBK, skv,
                               nthreads);
    else
      cp_async_commit();
    if (!warp_live) continue;
    const int k0 = k_begin + it * kBK;
    const T* kst = ks + (it % kStages) * C::kKTile;
    const T* vst = vs + (it % kStages) * C::kVTile;
    const T* qsw = qs + warp * 16 * C::kKStride;
    // only tiles that some row sees in part are masked element by element
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > pf) ||
                      (window > 0 && pl - k0 >= window);
    attend_tile<T, DQK, DV>(qa, qlo, qsw, kst, vst, acc, m, l, scale, edge,
                            qpos, k0 + 2 * t, skv, causal, window);
  }
  cp_async_wait<0>();                     // no copy outlives the block

  reduce_l(l);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= rows) continue;
    const size_t orow = out_row(r);
    if (splits == 1) {
      T* dst = o + orow * DV + 2 * t;
#pragma unroll
      for (int n = 0; n < kDT; ++n)
        store_pair(dst + n * 8, acc[n][2 * hr], acc[n][2 * hr + 1], l[hr]);
    } else {
      const size_t slot = orow * splits + split;
      float* dst = part + slot * DV + 2 * t;
#pragma unroll
      for (int n = 0; n < kDT; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(ml + 2 * slot) = make_float2(m[hr], l[hr]);
    }
  }
}

// The merge, a block per output row: out[c] = sum_s w_s O_s[c] / sum_s
// w_s l_s with w_s = exp(m_s - M), M the largest m_s of a split with l_s
// > 0, summed in split order (thread c owns column c); 0 for a row no
// split saw a key of. The splits' O come into shared memory kMergeChunk
// at a time by all threads at once, so that the loads of a chunk are in
// flight together rather than one split after another.
constexpr int kMergeThreads = 128;        // >= dv
constexpr int kMergeChunk = 32;

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    flash_attention_splitkv_combine(const float* __restrict__ part,
                                    const float* __restrict__ ml,
                                    T* __restrict__ o, int dv, int splits) {
  extern __shared__ float ps[];           // [kMergeChunk][dv]
  __shared__ float ws[kMergeChunk], ls[kMergeChunk];
  __shared__ float red[kMergeThreads / 32];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* mlr = ml + 2 * row * splits;
  const float* pr = part + row * splits * dv;
  float mx = kNegInf;                     // a max: any order gives it
  for (int s = tid; s < splits; s += kMergeThreads)
    if (mlr[2 * s + 1] > 0.f) mx = fmaxf(mx, mlr[2 * s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (tid % 32 == 0) red[tid / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) mx = fmaxf(mx, red[w]);
  float num = 0.f, den = 0.f;
  for (int s0 = 0; s0 < splits; s0 += kMergeChunk) {
    const int n = min(kMergeChunk, splits - s0);
    __syncthreads();                      // the last chunk is consumed
    for (int i = tid; i < n * dv; i += kMergeThreads)
      ps[i] = pr[static_cast<size_t>(s0) * dv + i];
    if (tid < n) {
      const float l = mlr[2 * (s0 + tid) + 1];
      ws[tid] = l > 0.f ? expf(mlr[2 * (s0 + tid)] - mx) : 0.f;
      ls[tid] = l;
    }
    __syncthreads();
    if (tid < dv)
      for (int j = 0; j < n; ++j) {
        den += ws[j] * ls[j];
        num += ws[j] * ps[j * dv + tid];
      }
  }
  if (tid < dv)
    reconic::store_f32(o, row * dv + tid, den == 0.f ? 0.f : num / den);
}

// f32 words of the scratch of a call of `splits` splits: each output row's
// O (dv words) and (m, l) per split; 0 for one split.
long long scratch_words(int batch, int hq, int sq, int dv, int splits) {
  return splits > 1 ? static_cast<long long>(batch) * sq * hq * splits *
                          (dv + 2)
                    : 0;
}

template <typename T, int DQK, int DV>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* scratch, int batch, int hq, int hkv, int sq, int skv,
             int causal, int window, int qoff, float scale, int splits,
             int keys_per_split, cudaStream_t stream) {
  const long long rows = static_cast<long long>(hq / hkv) * sq;
  const int m_tiles = static_cast<int>((rows + kRows - 1) / kRows);
  const int warps = block_warps(rows);
  const int smem = Ring<T, DQK, DV>::smem_bytes(warps);
  auto kern = flash_attention_splitkv_kernel<T, DQK, DV>;
  const int e0 = allow_smem(kern, smem);
  if (e0 != 0) return e0;
  const long long n_out = static_cast<long long>(batch) * sq * hq * DV;
  float* ml = splits > 1 ? scratch + n_out * splits : nullptr;
  kern<<<dim3(batch * hkv, m_tiles, splits), 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), scratch, ml, hq, hkv, sq,
      skv, causal, window, qoff, scale, splits, keys_per_split);
  const int e = reconic::launch_status();
  if (e != 0 || splits == 1) return e;
  flash_attention_splitkv_combine<T>
      <<<static_cast<unsigned>(n_out / DV), kMergeThreads,
         kMergeChunk * DV * sizeof(float), stream>>>(
          scratch, ml, static_cast<T*>(o), DV, splits);
  return reconic::launch_status();
}

// Blocks of `warps` warps of the split kernel the current card holds at
// once (its SMs times the blocks an SM takes, by the occupancy
// calculator), or a negative cudaError_t.
template <typename T, int DQK, int DV>
int wave_d(int warps) {
  auto kern = flash_attention_splitkv_kernel<T, DQK, DV>;
  const int smem = Ring<T, DQK, DV>::smem_bytes(warps);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = static_cast<cudaError_t>(allow_smem(kern, smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      32 * warps, smem);
  return e == cudaSuccess ? sms * per_sm : -static_cast<int>(e);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* scratch, int batch, int hq, int hkv, int sq, int skv, int d,
           int dv, int causal, int window, int qoff, float scale, int splits,
           int keys_per_split, cudaStream_t stream) {
#define RECONIC_FA_SPLITKV_CASE(DQK, DV)                                    \
  if (d == DQK && dv == DV)                                                 \
    return launch_d<T, DQK, DV>(q, k, v, o, scratch, batch, hq, hkv, sq, skv, \
                                causal, window, qoff, scale, splits,        \
                                keys_per_split, stream);
  RECONIC_FA_SPLITKV_CASE(64, 64)
  RECONIC_FA_SPLITKV_CASE(128, 128)
  RECONIC_FA_SPLITKV_CASE(192, 128)
#undef RECONIC_FA_SPLITKV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The blocks of `warps` warps (1-4: block_warps of the call's packed
// rows) of the split kernel of (d, dv, dtype) that the current card holds
// at once: split_kv_plan's wave. A negative cudaError_t where the card
// cannot say, or -cudaErrorInvalidValue for head dims it is not built for
// or a warp count out of range.
RECONIC_API int reconic_flash_attention_splitkv_wave(int d, int dv,
                                                     int is_bf16, int warps) {
  if (warps < 1 || warps > kRows / 16)
    return -static_cast<int>(cudaErrorInvalidValue);
#define RECONIC_FA_SPLITKV_WAVE(DQK, DV)                                   \
  if (d == DQK && dv == DV)                                                \
    return is_bf16 ? wave_d<__nv_bfloat16, DQK, DV>(warps)                 \
                   : wave_d<float, DQK, DV>(warps);
  RECONIC_FA_SPLITKV_WAVE(64, 64)
  RECONIC_FA_SPLITKV_WAVE(128, 128)
  RECONIC_FA_SPLITKV_WAVE(192, 128)
#undef RECONIC_FA_SPLITKV_WAVE
  return -static_cast<int>(cudaErrorInvalidValue);
}

// The scratch reconic_flash_attention_splitkv takes, in f32 words: 0 for
// one split.
RECONIC_API long long reconic_flash_attention_splitkv_scratch_words(
    int batch, int hq, int sq, int dv, int splits) {
  if (batch < 0 || hq < 0 || sq < 0 || dv < 0 || splits < 1) return 0;
  return scratch_words(batch, hq, sq, dv, splits);
}

// q: (B, Sq, Hq, d), k: (B, Skv, Hkv, d), v: (B, Skv, Hkv, dv), out: (B,
// Sq, Hq, dv), all contiguous, 16-byte aligned and of one dtype (f32, or
// bf16 when is_bf16); Hq % Hkv == 0, (d, dv) one of (64, 64), (128, 128),
// (192, 128); B * Hkv < 2^31. window 0 means no window; q_offset (>= 0) is
// the position of q's first row among the keys. splits and keys_per_split
// (kernels/flash_attention.py:split_kv_plan): whole 64-key tiles, at most
// 65535 splits, that cover the visible keys [lo, hi) (lo the window's low
// edge of the first row, tile-aligned down; hi the causal bound of the
// last row, or Skv) with no split starting at or past hi; one split where
// no key is visible. scratch: 16-byte aligned, scratch_words f32 words,
// at least reconic_flash_attention_splitkv_scratch_words (none for one
// split).
RECONIC_API int reconic_flash_attention_splitkv(
    const void* q, const void* k, const void* v, void* out, void* scratch,
    long long scratch_words_given, int batch, int hq, int hkv, int sq,
    int skv, int d, int dv, int causal, int window, int q_offset,
    float scale, int is_bf16, int splits, int keys_per_split, void* stream) {
  if (batch < 0 || hkv <= 0 || hq % hkv || sq < 0 || skv < 0 ||
      window < 0 || q_offset < 0 ||
      static_cast<long long>(batch) * hkv > INT_MAX ||
      (static_cast<long long>(hq / hkv) * sq + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lo = range_lo(q_offset, window);
  const long long hi =
      causal ? std::min<long long>(skv, static_cast<long long>(q_offset) + sq)
             : skv;
  const long long visible = std::max(hi - lo, 1LL);
  if (splits < 1 || splits > 65535 || keys_per_split < kBK ||
      keys_per_split % kBK ||
      static_cast<long long>(splits) * keys_per_split < hi - lo ||
      static_cast<long long>(splits - 1) * keys_per_split >= visible)
    return static_cast<int>(cudaErrorInvalidValue);
  if (scratch_words_given < scratch_words(batch, hq, sq, dv, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(scratch)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (batch == 0 || sq == 0 || hq == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, sc, batch, hq, hkv, sq, skv, d,
                                 dv, causal, window, q_offset, scale, splits,
                                 keys_per_split, s);
  return launch<float>(q, k, v, out, sc, batch, hq, hkv, sq, skv, d, dv,
                       causal, window, q_offset, scale, splits,
                       keys_per_split, s);
}
