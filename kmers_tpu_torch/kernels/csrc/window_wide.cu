// Wide window kernels: ASCII reads -> canonical 128-bit k-mer words
// (33 <= k <= 64).
//
// Replaces the two Pallas functions of kmers_tpu/kernels/window_wide.py:
//   K7 pack_canonical_keys_wide  (33 <= k <= 63): folded key planes
//      (k3, k2, k1, k0), most significant first, the invalid flag in bit
//      31 of k3 (structurally clear: k3 holds 2k - 96 <= 30 bits); an
//      invalid lane is exactly (0x80000000, 0, 0, 0).
//   K8 pack_canonical_hash_wide  (33 <= k <= 64): c0..c3 (little-endian
//      words of the canonical word, c0 = bases 0..15), the 128-bit mixer
//      hash (hash_hi, hash_lo) and a valid byte.  As on the TPU, invalid
//      lanes keep what the body computed there; bytes past the row count
//      as base code 0, as the plain version's zero padding does, so the
//      kernel and its plain version agree on every lane.
// Lane p of a [B, L] output is the window that starts at base p.
//
// Both are byte-bound on paper (K7 17, K8 26 bytes a lane), and both run
// one rolled body, kt_roll_wide, as the TPU kernels share _wide_body.  A
// thread makes a run of WIDE_RUN consecutive lanes of the flattened [B, L]
// batch: it builds the run's first window and its reverse complement once
// (the swap ladder on each 64-bit word, the word swap, a 128-bit shift
// down to k bases), then rolls the other lanes in a base at a time (fw =
// fw >> 2 | c << 2(k-1), rc = (rc << 2 | 3 - c) & mask, both 128-bit),
// some 30 operations a lane where rebuilding each lane's window took some
// 8k + 60.  The block stages its tile plus the halo once as code bytes
// (kt_stage_codes: one 8-byte load a thread, each byte decoded once).  A
// lane is valid where the bases counted since the last non-base byte reach
// k and its base p in its row is at most L - k.  The word planes are
// staged in shared memory and leave as 16-byte stores of the block's
// contiguous lane range (kt_store_tile), each warp store on 512 contiguous
// bytes.
//
// K7: a run may cross into the next row, whose bytes then fill only the
// windows of lanes past L - k, which fold to the invalid constant whatever
// they hold, so any L >= k works.  At [4096, 256], k = 63, one wave of 512
// blocks, it reaches about half its memory bound by the profiler (PERF.md,
// section 6), 6x the one-lane body it replaced; 128-thread blocks are no
// faster.
//
// K8 ran the one-lane body (k byte decodes and two 64-bit reversal ladders
// a lane) at 13 % of its memory bound.  Now it rolls as K7 does.  Its
// invalid lanes are not folded: each must hold the plain version's window,
// whose bytes past the row's end are code 0, where the rolled window holds
// the next row's bytes.  So on a lane d = p + k - L > 0 bases past its
// row's end, the forward word keeps its low k - d bases and the reverse
// complement's low d bases are set to 3 (the complement of code 0): two
// 128-bit masks, and no rebuild at a row's start.  Then the 128-bit hash,
// two kt_mix64 a lane (16 multiplies), which cannot be rolled.  Its six
// word planes leave as K7's do, from 1024-lane tiles of 128 threads so
// that they fit the 48 KB of static shared memory (tiles of one warp, as
// K2 takes, were no faster here); its valid bytes go straight out, one
// 8-byte store a thread.

#include "common.cuh"

#define WIDE_RUN 8                      // lanes a thread: 1 built, 7 rolled
#define K7_THREADS 256
#define K7_TILE (K7_THREADS * WIDE_RUN)   // lanes a block
#define K8_THREADS 128
#define K8_TILE (K8_THREADS * WIDE_RUN)

// The low m bases (2m bits) of a 128-bit word, 0 <= m <= 64: the masks of
// its high and its low 64-bit word.
__device__ __forceinline__ u64 kt_low_bases_hi(int m) {
  return m <= 32 ? 0ull : ~0ull >> (128 - 2 * m);
}

__device__ __forceinline__ u64 kt_low_bases_lo(int m) {
  return m >= 32 ? ~0ull : (1ull << (2 * m)) - 1;
}

// The rolled wide body of K7 and K8, 33 <= k <= 64.  For each of the RUN
// lanes whose windows start at seg[b], seg[b + 1], ... (code bytes,
// kt_stage_codes), the first at base p of its row, it calls
// lane(i, fw_hi, fw_lo, rc_hi, rc_lo, valid, p): the window's forward word
// and reverse complement as the staged bytes give them (the next row's
// bytes where the window passes its row's end), whether the lane is valid
// and its base p in its row.
template <int RUN, class Lane>
__device__ __forceinline__ void kt_roll_wide(const uint8_t* seg, int b, int k,
                                             int p, int L, Lane lane) {
  int run = 0;                      // bases since the last non-base byte
  u64 lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const u32 e = seg[b + i];
    lo |= (u64)(e & 3u) << (2 * i);
    run = e & KT_NOT_BASE ? 0 : run + 1;
  }
  for (int i = 32; i < k; ++i) {
    const u32 e = seg[b + i];
    hi |= (u64)(e & 3u) << (2 * (i - 32));
    run = e & KT_NOT_BASE ? 0 : run + 1;
  }
  // reverse all 64 base slots of ~(hi, lo), then shift down by 64 - k
  // bases (0 <= s <= 62; none at k = 64)
  const u64 r_hi = kt_reverse_bases64(~lo), r_lo = kt_reverse_bases64(~hi);
  const int s = 2 * (64 - k);
  u64 rc_hi = r_hi >> s;
  u64 rc_lo = s ? (r_lo >> s) | (r_hi << (64 - s)) : r_lo;
  const u64 mask_hi = kt_low_bases_hi(k);
  const int top = 2 * k - 66;       // the last base's bit in hi
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    if (i) {                        // roll in base b + k - 1 + i
      const u32 e = seg[b + k - 1 + i];
      const u64 c = e & 3u;
      lo = (lo >> 2) | (hi << 62);
      hi = (hi >> 2) | (c << top);
      rc_hi = ((rc_hi << 2) | (rc_lo >> 62)) & mask_hi;
      rc_lo = (rc_lo << 2) | (3 - c);
      run = e & KT_NOT_BASE ? 0 : run + 1;
      if (++p == L) p = 0;
    }
    lane(i, hi, lo, rc_hi, rc_lo, run >= k && p <= L - k, p);
  }
}

// Unsigned 128-bit min(fw, rc), rc on ties (u128.min_).
__device__ __forceinline__ void kt_min128(u64 hi, u64 lo, u64 rc_hi,
                                          u64 rc_lo, u64* c_hi, u64* c_lo) {
  const bool fw_lt = hi < rc_hi || (hi == rc_hi && lo < rc_lo);
  *c_hi = fw_lt ? hi : rc_hi;
  *c_lo = fw_lt ? lo : rc_lo;
}

// K7: block = K7_TILE consecutive lanes of the flattened [B, L] batch (n
// lanes), thread t the lanes WIDE_RUN t .. WIDE_RUN t + WIDE_RUN - 1 of it.
__global__ void __launch_bounds__(K7_THREADS)
kt_pack_keys_wide_kernel(const uint8_t* __restrict__ reads,
                         u32* __restrict__ k3, u32* __restrict__ k2,
                         u32* __restrict__ k1, u32* __restrict__ k0,
                         long long n, int L, int k) {
  __shared__ __align__(16) uint8_t seg[K7_TILE + 64];   // code | NOT_BASE
  __shared__ __align__(16) u32 planes[4][K7_TILE];
  __shared__ int s_p;
  const long long t0 = (long long)blockIdx.x * K7_TILE;
  kt_stage_codes<K7_THREADS, WIDE_RUN>(reads, seg, t0, n, k, threadIdx.x);
  if (threadIdx.x == 0) s_p = (int)(t0 % L);
  __syncthreads();

  const int b = WIDE_RUN * threadIdx.x;
  u32 out[4][WIDE_RUN];
  kt_roll_wide<WIDE_RUN>(
      seg, b, k, (s_p + b) % L, L,
      [&](int i, u64 hi, u64 lo, u64 rc_hi, u64 rc_lo, bool valid, int) {
        u64 c_hi, c_lo;
        kt_min128(hi, lo, rc_hi, rc_lo, &c_hi, &c_lo);
        out[0][i] = valid ? (u32)(c_hi >> 32) : KT_INVALID_HI;
        out[1][i] = valid ? (u32)c_hi : 0u;
        out[2][i] = valid ? (u32)(c_lo >> 32) : 0u;
        out[3][i] = valid ? (u32)c_lo : 0u;
      });
  kt_put_run(planes, out, b);
  __syncthreads();
  u32* const dst[4] = {k3, k2, k1, k0};
  kt_store_tile<K7_THREADS, K7_TILE, 4>(planes, dst, t0, n, threadIdx.x);
}

// K8: as K7, in 1024-lane tiles, plus the 128-bit mixer hash
// (core/u128.py mix_hash: the high word hashed under seed ^ 0xA5A5A5A5,
// xored into the low word, hashed under seed).
__global__ void __launch_bounds__(K8_THREADS)
kt_pack_hash_wide_kernel(const uint8_t* __restrict__ reads,
                         u32* __restrict__ c0, u32* __restrict__ c1,
                         u32* __restrict__ c2, u32* __restrict__ c3,
                         u32* __restrict__ hash_hi, u32* __restrict__ hash_lo,
                         uint8_t* __restrict__ valid_out, long long n, int L,
                         int k, u64 seed) {
  __shared__ __align__(16) uint8_t seg[K8_TILE + 64];   // code | NOT_BASE
  __shared__ __align__(16) u32 planes[6][K8_TILE];
  __shared__ int s_p;
  const long long t0 = (long long)blockIdx.x * K8_TILE;
  kt_stage_codes<K8_THREADS, WIDE_RUN>(reads, seg, t0, n, k, threadIdx.x);
  if (threadIdx.x == 0) s_p = (int)(t0 % L);
  __syncthreads();

  const int b = WIDE_RUN * threadIdx.x;
  u32 out[6][WIDE_RUN];
  u64 vbytes = 0;                   // lane i's valid byte in bits 8i..
  kt_roll_wide<WIDE_RUN>(
      seg, b, k, (s_p + b) % L, L,
      [&](int i, u64 hi, u64 lo, u64 rc_hi, u64 rc_lo, bool valid, int p) {
        // bytes past the row's end are code 0, as in the plain version
        const int past = p + k - L;
        const int keep = past > 0 ? L - p : 64, fill = past > 0 ? past : 0;
        hi &= kt_low_bases_hi(keep);
        lo &= kt_low_bases_lo(keep);
        rc_hi |= kt_low_bases_hi(fill);
        rc_lo |= kt_low_bases_lo(fill);
        u64 c_hi, c_lo;
        kt_min128(hi, lo, rc_hi, rc_lo, &c_hi, &c_lo);
        const u64 inner = kt_mix64((u32)(c_hi >> 32), (u32)c_hi,
                                   seed ^ 0xA5A5A5A5ull);
        const u64 h = kt_mix64((u32)(c_lo >> 32) ^ (u32)(inner >> 32),
                               (u32)c_lo ^ (u32)inner, seed);
        out[0][i] = (u32)c_lo;
        out[1][i] = (u32)(c_lo >> 32);
        out[2][i] = (u32)c_hi;
        out[3][i] = (u32)(c_hi >> 32);
        out[4][i] = (u32)(h >> 32);
        out[5][i] = (u32)h;
        vbytes |= (u64)valid << (8 * i);
      });
  const long long f = t0 + b;
  if (f + WIDE_RUN <= n) {
    *reinterpret_cast<uint2*>(valid_out + f) =
        make_uint2((u32)vbytes, (u32)(vbytes >> 32));
  } else {
    for (int i = 0; f + i < n; ++i)
      valid_out[f + i] = (uint8_t)(vbytes >> (8 * i));
  }
  kt_put_run(planes, out, b);
  __syncthreads();
  u32* const dst[6] = {c0, c1, c2, c3, hash_hi, hash_lo};
  kt_store_tile<K8_THREADS, K8_TILE, 6>(planes, dst, t0, n, threadIdx.x);
}

KT_EXPORT int kt_pack_keys_wide(const void* reads, void* k3, void* k2,
                                void* k1, void* k0, int B, int L, int k,
                                void* stream) {
  const long long n = (long long)B * L;
  if (n == 0) return 0;
  kt_pack_keys_wide_kernel<<<(unsigned)((n + K7_TILE - 1) / K7_TILE),
                             K7_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (u32*)k3, (u32*)k2, (u32*)k1, (u32*)k0, n, L,
      k);
  return (int)cudaGetLastError();
}

KT_EXPORT int kt_pack_hash_wide(const void* reads, void* c0, void* c1,
                                void* c2, void* c3, void* hash_hi,
                                void* hash_lo, void* valid, int B, int L,
                                int k, unsigned long long seed,
                                void* stream) {
  const long long n = (long long)B * L;
  if (n == 0) return 0;
  kt_pack_hash_wide_kernel<<<(unsigned)((n + K8_TILE - 1) / K8_TILE),
                             K8_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (u32*)c0, (u32*)c1, (u32*)c2, (u32*)c3,
      (u32*)hash_hi, (u32*)hash_lo, (uint8_t*)valid, n, L, k, (u64)seed);
  return (int)cudaGetLastError();
}
