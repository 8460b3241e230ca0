// Minimizer kernel K9: reads -> the minimizer of every k-mer window.
//
// Replaces kmers_tpu/kernels/minimizer.py:minimizer_kernel.  For lane p of
// a [B, L] ASCII batch (the k-mer window that starts at base p) it emits
// the word and absolute position of the leftmost w-mer with the minimal
// order among positions p .. p+k-w, and whether the window holds only
// bases and p <= L-k.  Four orders, one template parameter each: mix64
// (kmers_tpu/core/u64.py mix_hash), mix32 (its low half, mix32_order),
// mix16 (the top 16 bits of mix32) and lex (the base reversal shifted to
// w bases, LexHasher).  Ties go to the leftmost candidate, which under
// mix16 selects the same lane as the TPU's packed (order16 << 12 | pos)
// key, without its L <= 4096 limit.  Invalid lanes are zero in every
// output, as in the plain version (kernels/minimizer.py), so the two agree
// on every lane.
//
// Bound: device-memory bytes, 1 read and 13 written per lane, if the
// integer work per lane is kept to a constant; the card's 32-bit integer
// rate (64 lanes a clock an SM, half its float rate) is what a heavier
// lane runs into first.  So no thread loops over k or over the W = k-w+1
// candidates.  A block owns one 256-lane segment of a row (a whole row at
// the count batch's L = 256) and has one thread for each byte of the
// segment and its (k-1)-byte halo ('N' past the row), rounded up to a
// warp, so that no step takes a second round on some warps.  Each warp
// reads 32 bytes once and keeps them in shared memory as
//   - a ballot of the bytes that are not bases: a window is valid iff its
//     k bits are zero, one funnel shift of at most three words;
//   - the 2-bit codes, 16 bases a word (an OR over each half-warp): any
//     w-mer (w <= 32) is a funnel shift of at most three words.
// Each candidate position's w-mer gets its order once, packed with the
// position so that the least key is the leftmost minimal order.  A sparse
// table takes the minimum over W: floor(log2 W) doubling steps in shared
// memory over all positions, then each lane takes the smaller of two
// overlapping entries (min is idempotent).  At k=31, w=11 that is four
// steps and two lookups against 21 dependent compares.
//
// Stage "hash" (the roofline ablation's arm of kmers_tpu/kernels/
// minimizer.py, which isolates the scan's cost) stops before the scan: a
// template flag, so its instances stage the segment as above and then
// emit for lane p the forward w-mer word that starts at p, int32(lo) ^
// int32(hi) of its order (mix16 as mix32 >> 16, the unpacked form JAX
// takes at that stage) and the k-window's validity, zero on invalid lanes
// as in stage "full", whose instances are unchanged.

#include "common.cuh"

#define MIN_LANES 256
// 32-byte chunks: the 256 lanes, a halo of up to 63 bytes, and the word a
// three-word funnel shift reads past the last one
#define MIN_CHUNKS 11
#define MIN_FULL 0xFFFFFFFFu

enum { KT_MIX64 = 0, KT_MIX32 = 1, KT_MIX16 = 2, KT_LEX = 3 };

template <int ORDER>
__device__ __forceinline__ u64 kt_wmer_order(u64 wm, int w, u64 seed) {
  if (ORDER == KT_MIX64) return kt_mix64((u32)(wm >> 32), (u32)wm, seed);
  if (ORDER == KT_LEX) return kt_reverse_bases64(wm) >> (64 - 2 * w);
  const u32 m32 = kt_mix32((u32)wm ^ kt_mix32((u32)(wm >> 32) ^ (u32)seed));
  return ORDER == KT_MIX32 ? m32 : m32 >> 16;
}

// A candidate: its order and its position q in the segment (q < 2^16).
// a < b iff a's order is smaller, or equal with a to the left.  mix16 and
// mix32 pack both into one word; the 64-bit orders keep a pair.
template <int ORDER>
struct MinCand {
  u64 order;
  u32 at;
  static __device__ __forceinline__ MinCand make(u64 o, u32 q) {
    return {o, q};
  }
  __device__ __forceinline__ u32 pos() const { return at; }
  __device__ __forceinline__ bool operator<(const MinCand& b) const {
    return order < b.order || (order == b.order && at < b.at);
  }
};

template <>
struct MinCand<KT_MIX16> {
  u32 key;
  static __device__ __forceinline__ MinCand make(u64 o, u32 q) {
    return {((u32)o << 16) | q};
  }
  __device__ __forceinline__ u32 pos() const { return key & 0xFFFFu; }
  __device__ __forceinline__ bool operator<(const MinCand& b) const {
    return key < b.key;
  }
};

template <>
struct MinCand<KT_MIX32> {
  u64 key;
  static __device__ __forceinline__ MinCand make(u64 o, u32 q) {
    return {(o << 32) | q};
  }
  __device__ __forceinline__ u32 pos() const { return (u32)key & 0xFFFFu; }
  __device__ __forceinline__ bool operator<(const MinCand& b) const {
    return key < b.key;
  }
};

// Bits [bit, bit + 64) of a little-endian array of u32 words.
__device__ __forceinline__ u64 kt_bits64(const u32* words, int bit) {
  const int i = bit >> 5, s = bit & 31;
  return kt_word(__funnelshift_r(words[i + 1], words[i + 2], s),
                 __funnelshift_r(words[i], words[i + 1], s));
}

// Block: n_seg = MIN_LANES + k - 1 threads rounded up to a warp, thread i
// on byte i of the segment.  Shared memory: two arrays of n_w =
// MIN_LANES + k - w candidates (the sparse table's ping-pong levels); none
// at stage "hash" (HASH).
template <int ORDER, bool HASH>
__global__ void __launch_bounds__(MIN_CHUNKS * 32)
kt_minimizer_kernel(const uint8_t* __restrict__ reads,
                    u32* __restrict__ word_hi, u32* __restrict__ word_lo,
                    int* __restrict__ pos_out, uint8_t* __restrict__ valid_out,
                    int L, int k, int w, int segs, u64 seed) {
  typedef MinCand<ORDER> Cand;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ u32 bad[MIN_CHUNKS];           // bit i: byte i is no base
  __shared__ u32 codes[2 * MIN_CHUNKS];     // 2-bit code of byte i
  const int n_w = MIN_LANES + k - w;
  Cand* cur = (Cand*)smem;
  Cand* nxt = cur + n_w;
  const long long row = blockIdx.x / segs;
  const int p0 = (int)(blockIdx.x % segs) * MIN_LANES;
  const int tid = threadIdx.x, lane = tid & 31, chunk = tid >> 5;
  const uint8_t* rd = reads + row * L;

  {
    const int p = p0 + tid;
    bool ok;
    const u32 code = kt_code(tid < MIN_LANES + k - 1 && p < L ? rd[p] : 'N',
                             &ok);
    const u32 nb = __ballot_sync(MIN_FULL, !ok);
    u32 packed = code << (2 * (lane & 15));
#pragma unroll
    for (int s = 1; s < 16; s <<= 1)
      packed |= __shfl_xor_sync(MIN_FULL, packed, s);
    if (lane == 0) bad[chunk] = nb;
    if ((lane & 15) == 0) codes[2 * chunk + (lane >> 4)] = packed;
    // the words past the block's chunks, which funnel shifts read and mask
    if (tid < MIN_CHUNKS - (int)(blockDim.x >> 5)) {
      bad[(blockDim.x >> 5) + tid] = MIN_FULL;
      codes[2 * (blockDim.x >> 5) + 2 * tid] = 0;
      codes[2 * (blockDim.x >> 5) + 2 * tid + 1] = 0;
    }
  }
  __syncthreads();

  const u64 wmask = w == 32 ? ~0ull : (1ull << (2 * w)) - 1;
  if (HASH) {
    const int p = p0 + tid;
    if (tid >= MIN_LANES || p >= L) return;
    const u64 kmask = k == 64 ? ~0ull : (1ull << k) - 1;
    const bool valid = p <= L - k && (kt_bits64(bad, tid) & kmask) == 0;
    const u64 wm = kt_bits64(codes, 2 * tid) & wmask;
    const u64 o = kt_wmer_order<ORDER>(wm, w, seed);
    const long long lane_out = row * L + p;
    word_hi[lane_out] = valid ? (u32)(wm >> 32) : 0u;
    word_lo[lane_out] = valid ? (u32)wm : 0u;
    pos_out[lane_out] = valid ? (int)((u32)o ^ (u32)(o >> 32)) : 0;
    valid_out[lane_out] = valid;
    return;
  }
  if (tid < n_w)
    cur[tid] = Cand::make(
        kt_wmer_order<ORDER>(kt_bits64(codes, 2 * tid) & wmask, w, seed),
        tid);
  __syncthreads();
  // level s holds the least candidate of [q, q + 2^s), for q <= n_w - 2^s
  const int W = k - w + 1;
  const int levels = 31 - __clz(W);
  for (int s = 0; s < levels; ++s) {
    const int h = 1 << s;
    if (tid + 2 * h <= n_w) {
      const Cand a = cur[tid], b = cur[tid + h];
      nxt[tid] = b < a ? b : a;
    }
    __syncthreads();
    Cand* t = cur;
    cur = nxt;
    nxt = t;
  }

  const int p = p0 + tid;
  if (tid >= MIN_LANES || p >= L) return;
  const u64 kmask = k == 64 ? ~0ull : (1ull << k) - 1;
  const bool valid = p <= L - k && (kt_bits64(bad, tid) & kmask) == 0;
  const Cand a = cur[tid], b = cur[tid + W - (1 << levels)];
  const int q = (b < a ? b : a).pos();
  const u64 wm = valid ? kt_bits64(codes, 2 * q) & wmask : 0ull;
  const long long lane_out = row * L + p;
  word_hi[lane_out] = (u32)(wm >> 32);
  word_lo[lane_out] = (u32)wm;
  pos_out[lane_out] = valid ? p0 + q : 0;
  valid_out[lane_out] = valid;
}

template <int ORDER>
static int kt_minimizer_launch(const void* reads, void* word_hi,
                               void* word_lo, void* pos, void* valid, int B,
                               int L, int k, int w, u64 seed, bool hash,
                               cudaStream_t stream) {
  const int segs = (L + MIN_LANES - 1) / MIN_LANES;
  const long long blocks = (long long)B * segs;
  const int threads = (MIN_LANES + k - 1 + 31) / 32 * 32;
  const size_t smem =
      hash ? 0 : 2 * (size_t)(MIN_LANES + k - w) * sizeof(MinCand<ORDER>);
  auto kernel = hash ? kt_minimizer_kernel<ORDER, true>
                     : kt_minimizer_kernel<ORDER, false>;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      (const uint8_t*)reads, (u32*)word_hi, (u32*)word_lo, (int*)pos,
      (uint8_t*)valid, L, k, w, segs, seed);
  return (int)cudaGetLastError();
}

// order: 0 mix64, 1 mix32, 2 mix16, 3 lex (kernels/minimizer.py ORDERS);
// hash: 0 stage "full", 1 stage "hash".
KT_EXPORT int kt_minimizer(const void* reads, void* word_hi, void* word_lo,
                           void* pos, void* valid, int B, int L, int k, int w,
                           unsigned long long seed, int order, int hash,
                           void* stream) {
  if ((long long)B * L == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case KT_MIX64:
      return kt_minimizer_launch<KT_MIX64>(reads, word_hi, word_lo, pos,
                                           valid, B, L, k, w, seed, hash, s);
    case KT_MIX32:
      return kt_minimizer_launch<KT_MIX32>(reads, word_hi, word_lo, pos,
                                           valid, B, L, k, w, seed, hash, s);
    case KT_MIX16:
      return kt_minimizer_launch<KT_MIX16>(reads, word_hi, word_lo, pos,
                                           valid, B, L, k, w, seed, hash, s);
    case KT_LEX:
      return kt_minimizer_launch<KT_LEX>(reads, word_hi, word_lo, pos, valid,
                                         B, L, k, w, seed, hash, s);
  }
  return (int)cudaErrorInvalidValue;
}
