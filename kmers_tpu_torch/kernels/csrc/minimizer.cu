// Minimizer kernel K9: reads -> the minimizer of every k-mer window.
//
// Replaces kmers_tpu/kernels/minimizer.py:minimizer_kernel.  For lane p of
// a [B, L] ASCII batch (the k-mer window that starts at base p) it emits
// the word and absolute position of the leftmost w-mer with the minimal
// order among positions p .. p+k-w, and whether the window holds only
// bases and p <= L-k.  Four orders, one template parameter each: mix64
// (kmers_tpu/core/u64.py mix_hash), mix32 (its low half, mix32_order),
// mix16 (the top 16 bits of mix32) and lex (the base reversal shifted to
// w bases, LexHasher).  Ties go to the leftmost candidate: a strict <
// over the candidates from left to right.  Under mix16 this selects the
// same lane as the TPU's packed (order16 << 12 | pos) key, without its
// L <= 4096 limit.  Invalid lanes are zero in every output, as in the
// plain version (kernels/minimizer.py), so the two agree on every lane.
//
// Bound: integer work, not memory.  Per output lane the kernel reads 1
// byte and writes 13; it does about k byte decodes (validity), w decodes
// and one order (the w-mer words are shared by W = k-w+1 lanes) and W
// compares.  The TPU kernel's van Herk/Gil-Werman scan (O(log W) rolled
// compares) answered a vector unit that pays per roll; here each thread
// scans its W candidates from shared memory, where the block has staged
// its row segment plus a (k-1)-byte halo ('N' past the row) and computed
// every position's w-mer word and order once.

#include "common.cuh"

#define MIN_THREADS 256

enum { KT_MIX64 = 0, KT_MIX32 = 1, KT_MIX16 = 2, KT_LEX = 3 };

template <int ORDER>
__device__ __forceinline__ u64 kt_wmer_order(u64 wm, int w, u64 seed) {
  if (ORDER == KT_MIX64) return kt_mix64((u32)(wm >> 32), (u32)wm, seed);
  if (ORDER == KT_LEX) return kt_reverse_bases64(wm) >> (64 - 2 * w);
  const u32 m32 = kt_mix32((u32)wm ^ kt_mix32((u32)(wm >> 32) ^ (u32)seed));
  return ORDER == KT_MIX32 ? m32 : m32 >> 16;
}

// Block = one MIN_THREADS-lane segment of one row.  Shared memory: the
// w-mer words and orders of the n_w = MIN_THREADS + k - w positions the
// segment's windows read, then the staged bytes.
template <int ORDER>
__global__ void kt_minimizer_kernel(const uint8_t* __restrict__ reads,
                                    u32* __restrict__ word_hi,
                                    u32* __restrict__ word_lo,
                                    int* __restrict__ pos_out,
                                    uint8_t* __restrict__ valid_out, int L,
                                    int k, int w, int segs, u64 seed) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int n_w = MIN_THREADS + k - w;
  u64* wword = (u64*)smem;
  u64* worder = wword + n_w;
  uint8_t* seg = (uint8_t*)(worder + n_w);
  const long long row = blockIdx.x / segs;
  const int p0 = (int)(blockIdx.x % segs) * MIN_THREADS;
  kt_stage_segment(reads, seg, row, p0, MIN_THREADS + k - 1, L, 'N');
  for (int q = threadIdx.x; q < n_w; q += blockDim.x) {
    u64 wm = 0;
    for (int i = 0; i < w; ++i) {
      bool ok;
      wm |= (u64)kt_code(seg[q + i], &ok) << (2 * i);
    }
    wword[q] = wm;
    worder[q] = kt_wmer_order<ORDER>(wm, w, seed);
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int p = p0 + t;
  if (p >= L) return;
  bool valid = p <= L - k;
  for (int i = 0; i < k; ++i) {
    bool ok;
    kt_code(seg[t + i], &ok);
    valid &= ok;
  }
  int best = 0;
  u64 best_order = worder[t];
  for (int j = 1; j <= k - w; ++j) {
    const u64 o = worder[t + j];
    if (o < best_order) {
      best_order = o;
      best = j;
    }
  }
  const long long lane = row * L + p;
  const u64 wm = valid ? wword[t + best] : 0ull;
  word_hi[lane] = (u32)(wm >> 32);
  word_lo[lane] = (u32)wm;
  pos_out[lane] = valid ? p + best : 0;
  valid_out[lane] = valid;
}

template <int ORDER>
static int kt_minimizer_launch(const void* reads, void* word_hi,
                               void* word_lo, void* pos, void* valid, int B,
                               int L, int k, int w, u64 seed,
                               cudaStream_t stream) {
  const int segs = (L + MIN_THREADS - 1) / MIN_THREADS;
  const long long blocks = (long long)B * segs;
  const size_t n_w = MIN_THREADS + k - w;
  const size_t smem = 16 * n_w + MIN_THREADS + k - 1;
  kt_minimizer_kernel<ORDER><<<(unsigned)blocks, MIN_THREADS, smem, stream>>>(
      (const uint8_t*)reads, (u32*)word_hi, (u32*)word_lo, (int*)pos,
      (uint8_t*)valid, L, k, w, segs, seed);
  return (int)cudaGetLastError();
}

// order: 0 mix64, 1 mix32, 2 mix16, 3 lex (kernels/minimizer.py ORDERS).
KT_EXPORT int kt_minimizer(const void* reads, void* word_hi, void* word_lo,
                           void* pos, void* valid, int B, int L, int k, int w,
                           unsigned long long seed, int order, void* stream) {
  if ((long long)B * L == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case KT_MIX64:
      return kt_minimizer_launch<KT_MIX64>(reads, word_hi, word_lo, pos,
                                           valid, B, L, k, w, seed, s);
    case KT_MIX32:
      return kt_minimizer_launch<KT_MIX32>(reads, word_hi, word_lo, pos,
                                           valid, B, L, k, w, seed, s);
    case KT_MIX16:
      return kt_minimizer_launch<KT_MIX16>(reads, word_hi, word_lo, pos,
                                           valid, B, L, k, w, seed, s);
    case KT_LEX:
      return kt_minimizer_launch<KT_LEX>(reads, word_hi, word_lo, pos, valid,
                                         B, L, k, w, seed, s);
  }
  return (int)cudaErrorInvalidValue;
}
