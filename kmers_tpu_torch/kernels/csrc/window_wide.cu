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
// K8 stages a block's WIN_THREADS-lane row segment plus the (k-1)-byte
// halo in shared memory once; each thread packs its own lane's k bytes
// into a (hi, lo) pair of 64-bit words, reverse-complements it
// (complement, the swap ladder on each word, the word swap, a 128-bit
// shift down to k bases) and takes the unsigned minimum (kt_wide_body, as
// the TPU kernels share _wide_body).  That is some 8k + 60 integer
// operations a lane against 1 byte read and 25 bytes written, so at
// k = 63 its loop over the k bytes, not device memory, bounds it.
//
// K7 ran the same body and so was bound by the integer rate too, at 8 %
// of its 17-byte-a-lane memory bound.  Now a thread makes a run of K7_RUN
// consecutive lanes of the flattened [B, L] batch: it builds the run's
// first window as kt_wide_body does, then rolls the other lanes in a base
// at a time (fw = fw >> 2 | c << 2(k-1), rc = (rc << 2 | 3 - c) & mask,
// both 128-bit), some 30 operations a lane.  The block stages its
// K7_TILE-byte range plus the halo once, one 8-byte load a thread, each
// byte turned into its 2-bit code and a not-a-base flag (four bytes at a
// time), so no lane decodes a byte again.  A lane is
// valid where the bases counted since the last non-base byte reach k and
// its base p in its row is at most L - k: a run may cross into the next
// row, whose bytes then fill only the windows of lanes past L - k, which
// are invalid whatever they hold, so any L >= k works.  The four output
// planes are staged in shared memory and leave as 16-byte stores of the
// block's contiguous lane range, each warp store on 512 contiguous bytes.
// At [4096, 256], k = 63, one wave of 512 blocks, it reaches about half
// its memory bound by the profiler (PERF.md, section 6), 6x the one-lane
// body; 128-thread blocks are no faster.

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

#define K7_RUN 8                        // lanes a thread: 1 built, 7 rolled
#define K7_THREADS 256
#define K7_TILE (K7_THREADS * K7_RUN)   // lanes a block
#define K7_NOT_BASE 4                   // flag of a staged byte

// Four ASCII bytes at once: each byte's 2-bit code, plus K7_NOT_BASE where
// it is not one of ACGTacgt (kt_code, byte by byte).
__device__ __forceinline__ u32 kt_code_flag4(u32 w) {
  const u32 internal = (w >> 1) & 0x03030303u;   // A=0 C=1 T=2 G=3
  const u32 lower = w | 0x20202020u;
  const u32 ok = __vcmpeq4(lower, 0x61616161u) | __vcmpeq4(lower, 0x63636363u) |
                 __vcmpeq4(lower, 0x67676767u) | __vcmpeq4(lower, 0x74747474u);
  return (internal ^ ((internal >> 1) & 0x01010101u)) | (~ok & 0x04040404u);
}

// K7: block = K7_TILE consecutive lanes of the flattened [B, L] batch (n
// lanes), thread t the lanes K7_RUN t .. K7_RUN t + K7_RUN - 1 of it.
// The output planes are fresh allocations, so 16-byte aligned.
__global__ void __launch_bounds__(K7_THREADS)
kt_pack_keys_wide_kernel(const uint8_t* __restrict__ reads,
                         u32* __restrict__ k3, u32* __restrict__ k2,
                         u32* __restrict__ k1, u32* __restrict__ k0,
                         long long n, int L, int k) {
  __shared__ __align__(8) uint8_t seg[K7_TILE + 64];   // code | NOT_BASE
  __shared__ __align__(16) u32 planes[4][K7_TILE];
  __shared__ int s_p;
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * K7_TILE;
  if (t0 + K7_TILE + k - 1 <= n && ((uintptr_t)reads & 7) == 0) {
    // the tile's bytes as one 8-byte load a thread, then the halo
    const uint2 w = *reinterpret_cast<const uint2*>(reads + t0 + 8 * tid);
    *reinterpret_cast<uint2*>(&seg[8 * tid]) =
        make_uint2(kt_code_flag4(w.x), kt_code_flag4(w.y));
    if (tid < k - 1)
      seg[K7_TILE + tid] = (uint8_t)kt_code_flag4(reads[t0 + K7_TILE + tid]);
  } else {
    for (int i = tid; i < K7_TILE + k - 1; i += K7_THREADS)
      seg[i] = (uint8_t)kt_code_flag4(t0 + i < n ? reads[t0 + i] : 'A');
  }
  if (tid == 0) s_p = (int)(t0 % L);
  __syncthreads();

  // the run's first window: bases b .. b + k - 1 of the tile
  const int b = K7_RUN * tid;
  int p = (s_p + b) % L;            // the lane's base in its row
  int run = 0;                      // bases since the last non-base byte
  u64 lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const u32 e = seg[b + i];
    lo |= (u64)(e & 3u) << (2 * i);
    run = e & K7_NOT_BASE ? 0 : run + 1;
  }
  for (int i = 32; i < k; ++i) {
    const u32 e = seg[b + i];
    hi |= (u64)(e & 3u) << (2 * (i - 32));
    run = e & K7_NOT_BASE ? 0 : run + 1;
  }
  // reverse all 64 base slots of ~(hi, lo), then shift down by 64 - k
  // bases (2 <= s <= 62)
  const u64 r_hi = kt_reverse_bases64(~lo), r_lo = kt_reverse_bases64(~hi);
  const int s = 2 * (64 - k);
  u64 rc_hi = r_hi >> s, rc_lo = (r_lo >> s) | (r_hi << (64 - s));
  const u64 mask_hi = (1ull << (2 * k - 64)) - 1;
  const int top = 2 * k - 66;       // the last base's bit in hi

  u32 out[4][K7_RUN];
#pragma unroll
  for (int i = 0; i < K7_RUN; ++i) {
    if (i) {                        // roll in base b + k - 1 + i
      const u32 e = seg[b + k - 1 + i];
      const u64 c = e & 3u;
      lo = (lo >> 2) | (hi << 62);
      hi = (hi >> 2) | (c << top);
      rc_hi = ((rc_hi << 2) | (rc_lo >> 62)) & mask_hi;
      rc_lo = (rc_lo << 2) | (3 - c);
      run = e & K7_NOT_BASE ? 0 : run + 1;
      if (++p == L) p = 0;
    }
    const bool fw_lt = hi < rc_hi || (hi == rc_hi && lo < rc_lo);
    const u64 c_hi = fw_lt ? hi : rc_hi, c_lo = fw_lt ? lo : rc_lo;
    const bool valid = run >= k && p <= L - k;
    out[0][i] = valid ? (u32)(c_hi >> 32) : KT_INVALID_HI;
    out[1][i] = valid ? (u32)c_hi : 0u;
    out[2][i] = valid ? (u32)(c_lo >> 32) : 0u;
    out[3][i] = valid ? (u32)c_lo : 0u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < K7_RUN; i += 4)
      *reinterpret_cast<uint4*>(&planes[j][b + i]) =
          make_uint4(out[j][i], out[j][i + 1], out[j][i + 2], out[j][i + 3]);
  __syncthreads();

  u32* dst[4] = {k3, k2, k1, k0};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    for (int q = tid; q < K7_TILE / 4; q += K7_THREADS) {
      const long long f = t0 + 4 * q;
      if (f + 4 <= n) {
        *reinterpret_cast<uint4*>(dst[j] + f) =
            *reinterpret_cast<const uint4*>(&planes[j][4 * q]);
      } else {
        for (int e = 0; f + e < n; ++e) dst[j][f + e] = planes[j][4 * q + e];
      }
    }
  }
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
