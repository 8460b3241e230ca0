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
// Both share one device function for the window body, as the TPU kernels
// share _wide_body: a block stages its WIN_THREADS-lane row segment plus
// the (k-1)-byte halo in shared memory once, each thread packs its k
// bytes into a (hi, lo) pair of 64-bit words, reverse-complements it
// (complement, the swap ladder on each word, the word swap, a 128-bit
// shift down to k bases) and takes the unsigned minimum.  Per lane that
// is some 8k + 60 integer operations against 1 byte read and 16 (K7) or
// 25 (K8) bytes written, so at k = 63 the loop over the k bytes, not
// device memory, bounds these kernels; one thread per lane keeps every
// 32-bit store of a warp one contiguous 128-byte line.

#include "common.cuh"

#define WIN_THREADS 256

// Canonical 128-bit word of the window at seg[t..t+k-1], and whether all
// its bytes are bases.
__device__ __forceinline__ void kt_wide_body(const uint8_t* seg, int t, int k,
                                             u64* c_hi, u64* c_lo,
                                             bool* bases) {
  u64 lo = 0, hi = 0;
  bool ok_all = true;
  for (int i = 0; i < 32; ++i) {
    bool ok;
    lo |= (u64)kt_code(seg[t + i], &ok) << (2 * i);
    ok_all &= ok;
  }
  for (int i = 32; i < k; ++i) {
    bool ok;
    hi |= (u64)kt_code(seg[t + i], &ok) << (2 * (i - 32));
    ok_all &= ok;
  }
  *bases = ok_all;
  // reverse all 64 base slots of ~(hi, lo), then shift down by 64 - k
  const u64 r_hi = kt_reverse_bases64(~lo), r_lo = kt_reverse_bases64(~hi);
  const int s = 2 * (64 - k);
  const u64 rc_hi = s ? r_hi >> s : r_hi;
  const u64 rc_lo = s ? (r_lo >> s) | (r_hi << (64 - s)) : r_lo;
  const bool fw_lt = hi < rc_hi || (hi == rc_hi && lo < rc_lo);
  *c_hi = fw_lt ? hi : rc_hi;
  *c_lo = fw_lt ? lo : rc_lo;
}

// K7: block = one WIN_THREADS-lane segment of one row.
__global__ void kt_pack_keys_wide_kernel(const uint8_t* __restrict__ reads,
                                         u32* __restrict__ k3,
                                         u32* __restrict__ k2,
                                         u32* __restrict__ k1,
                                         u32* __restrict__ k0, int L, int k,
                                         int segs) {
  extern __shared__ uint8_t seg[];
  const long long row = blockIdx.x / segs;
  const int p0 = (int)(blockIdx.x % segs) * WIN_THREADS;
  kt_stage_segment(reads, seg, row, p0, WIN_THREADS + k - 1, L, 'A');
  const int p = p0 + threadIdx.x;
  if (p >= L) return;

  u64 c_hi, c_lo;
  bool bases;
  kt_wide_body(seg, threadIdx.x, k, &c_hi, &c_lo, &bases);
  const bool valid = bases && p <= L - k;
  const long long lane = row * L + p;
  k3[lane] = valid ? (u32)(c_hi >> 32) : KT_INVALID_HI;
  k2[lane] = valid ? (u32)c_hi : 0u;
  k1[lane] = valid ? (u32)(c_lo >> 32) : 0u;
  k0[lane] = valid ? (u32)c_lo : 0u;
}

// K8: the same body, plus the 128-bit mixer hash (core/u128.py mix_hash:
// the high word hashed under seed ^ 0xA5A5A5A5, xored into the low word,
// hashed under seed).
__global__ void kt_pack_hash_wide_kernel(const uint8_t* __restrict__ reads,
                                         u32* __restrict__ c0,
                                         u32* __restrict__ c1,
                                         u32* __restrict__ c2,
                                         u32* __restrict__ c3,
                                         u32* __restrict__ hash_hi,
                                         u32* __restrict__ hash_lo,
                                         uint8_t* __restrict__ valid_out,
                                         int L, int k, int segs, u64 seed) {
  extern __shared__ uint8_t seg[];
  const long long row = blockIdx.x / segs;
  const int p0 = (int)(blockIdx.x % segs) * WIN_THREADS;
  kt_stage_segment(reads, seg, row, p0, WIN_THREADS + k - 1, L, 'A');
  const int p = p0 + threadIdx.x;
  if (p >= L) return;

  u64 c_hi, c_lo;
  bool bases;
  kt_wide_body(seg, threadIdx.x, k, &c_hi, &c_lo, &bases);
  const u64 inner = kt_mix64((u32)(c_hi >> 32), (u32)c_hi,
                             seed ^ 0xA5A5A5A5ull);
  const u64 h = kt_mix64((u32)(c_lo >> 32) ^ (u32)(inner >> 32),
                         (u32)c_lo ^ (u32)inner, seed);
  const long long lane = row * L + p;
  c0[lane] = (u32)c_lo;
  c1[lane] = (u32)(c_lo >> 32);
  c2[lane] = (u32)c_hi;
  c3[lane] = (u32)(c_hi >> 32);
  hash_hi[lane] = (u32)(h >> 32);
  hash_lo[lane] = (u32)h;
  valid_out[lane] = bases && p <= L - k;
}

KT_EXPORT int kt_pack_keys_wide(const void* reads, void* k3, void* k2,
                                void* k1, void* k0, int B, int L, int k,
                                void* stream) {
  if ((long long)B * L == 0) return 0;
  const int segs = (L + WIN_THREADS - 1) / WIN_THREADS;
  const long long blocks = (long long)B * segs;
  const size_t smem = WIN_THREADS + k - 1;
  kt_pack_keys_wide_kernel<<<(unsigned)blocks, WIN_THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (u32*)k3, (u32*)k2, (u32*)k1, (u32*)k0, L, k,
      segs);
  return (int)cudaGetLastError();
}

KT_EXPORT int kt_pack_hash_wide(const void* reads, void* c0, void* c1,
                                void* c2, void* c3, void* hash_hi,
                                void* hash_lo, void* valid, int B, int L,
                                int k, unsigned long long seed,
                                void* stream) {
  if ((long long)B * L == 0) return 0;
  const int segs = (L + WIN_THREADS - 1) / WIN_THREADS;
  const long long blocks = (long long)B * segs;
  const size_t smem = WIN_THREADS + k - 1;
  kt_pack_hash_wide_kernel<<<(unsigned)blocks, WIN_THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (u32*)c0, (u32*)c1, (u32*)c2, (u32*)c3,
      (u32*)hash_hi, (u32*)hash_lo, (uint8_t*)valid, L, k, segs, (u64)seed);
  return (int)cudaGetLastError();
}
