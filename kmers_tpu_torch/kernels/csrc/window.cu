// Window kernels: reads -> canonical k-mer words (1 <= k <= 32).
//
// Replaces three Pallas functions of kmers_tpu/kernels/window.py:
//   K1 pack_canonical_keys_packed  (packed 2-bit words + validity bitmaps)
//   K2 pack_canonical_keys         (ASCII bytes, stage "canon")
//   K5 pack_canonical_hash         (ASCII bytes, canonical word + hash)
// Output planes are [B, L], lane p = the window that starts at base p
// ("p-order").  K1/K2 (k <= 31) emit two int32 planes: a valid lane holds
// the canonical word (hi, lo), an invalid lane is exactly (0x80000000, 0)
// -- the invalid flag folded into bit 31 of hi, structurally clear for
// k <= 31.  K5 (k <= 32) emits canon hi/lo, hash hi/lo and a valid byte,
// the four words zero on invalid lanes (window.py:177-186).
//
// All three are bound by device-memory bytes: per output lane they do
// some 40 (K5: 60) integer operations against 8 (K5: 17) bytes written
// and 0.5 (K1) or 1 (K2, K5) bytes read.  The design keeps the traffic
// at that floor: one thread per output lane, so each 32-bit store of a
// warp is one contiguous 128-byte line; K1 reads the <= 3 code words and
// <= 2 validity words its window spans, which neighbouring threads share
// in L1; K2/K5 stage a row segment plus its (k-1)-byte halo in shared
// memory once, so every input byte crosses device memory once.  The TPU
// kernel's q-layout, rolls, L % 128 limit and block-row limit were
// workarounds for Mosaic and have no counterpart here: the unit table is
// a multiset, so p-order serves it for any L % 32 == 0.

#include "common.cuh"

#define WIN_THREADS 256

// Shared tail of K1, K2 and K5 (window.py:_canon_hash_tail): reverse
// complement by complement + swap ladder + shift, canonical = min(fw, rc)
// by (hi, lo).
__device__ __forceinline__ u64 kt_canonical64(u64 fw, int k) {
  const u64 rc = kt_revcomp64(fw, k);
  return fw < rc ? fw : rc;
}

// K1/K2: the canonical word with the invalid flag folded in.
__device__ __forceinline__ void kt_fold_canonical(u64 fw, int k, bool valid,
                                                  u32* out_hi, u32* out_lo) {
  const u64 c = kt_canonical64(fw, k);
  *out_hi = valid ? (u32)(c >> 32) : KT_INVALID_HI;
  *out_lo = valid ? (u32)c : 0u;
}

// The forward word of the window at seg[t..t+k-1] (k <= 32) and whether
// all its bytes are bases.
__device__ __forceinline__ u64 kt_window64(const uint8_t* seg, int t, int k,
                                           bool* valid) {
  u64 fw = 0;
  bool ok_all = true;
  for (int i = 0; i < k; ++i) {
    bool ok;
    fw |= (u64)kt_code(seg[t + i], &ok) << (2 * i);
    ok_all &= ok;
  }
  *valid = ok_all;
  return fw;
}

// K1: one thread per output lane of a [B, L] batch, L % 32 == 0.
__global__ void kt_pack_keys_packed_kernel(const u32* __restrict__ words,
                                           const u32* __restrict__ vbits,
                                           u32* __restrict__ out_hi,
                                           u32* __restrict__ out_lo,
                                           long long n_lanes, int L, int k) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const long long row = lane / L;
  const int p = (int)(lane - row * L);
  const int nw = L / 16, nv = L / 32;
  const u32* w = words + row * nw;
  const u32* v = vbits + row * nv;

  // bases p.. from the 96 bits of code words j, j+1, j+2 (zero past the row)
  const int j = p >> 4, r = p & 15;
  const u32 w0 = w[j];
  const u32 w1 = j + 1 < nw ? w[j + 1] : 0u;
  const u32 w2 = j + 2 < nw ? w[j + 2] : 0u;
  u64 fw = kt_word(w1, w0) >> (2 * r);
  if (r) fw |= (u64)w2 << (64 - 2 * r);
  fw &= (1ull << (2 * k)) - 1;

  // k validity bits from the 64 bits of bitmap words vj, vj+1
  const int vj = p >> 5, vr = p & 31;
  const u64 vw = (u64)v[vj] | (vj + 1 < nv ? (u64)v[vj + 1] << 32 : 0ull);
  const u64 need = (1ull << k) - 1;
  const bool valid = p <= L - k && ((vw >> vr) & need) == need;

  kt_fold_canonical(fw, k, valid, out_hi + lane, out_lo + lane);
}

// K2: block = one WIN_THREADS-lane segment of one row; the segment's
// bytes plus a (k-1)-byte halo are staged in shared memory ('N' past L).
__global__ void kt_pack_keys_ascii_kernel(const uint8_t* __restrict__ reads,
                                          u32* __restrict__ out_hi,
                                          u32* __restrict__ out_lo,
                                          int L, int k, int segs) {
  extern __shared__ uint8_t seg[];
  const long long row = blockIdx.x / segs;
  const int p0 = (int)(blockIdx.x % segs) * WIN_THREADS;
  kt_stage_segment(reads, seg, row, p0, WIN_THREADS + k - 1, L, 'N');
  const int p = p0 + threadIdx.x;
  if (p >= L) return;

  bool bases;
  const u64 fw = kt_window64(seg, threadIdx.x, k, &bases);
  const long long lane = row * L + p;
  kt_fold_canonical(fw, k, bases && p <= L - k, out_hi + lane,
                    out_lo + lane);
}

// K5: as K2, plus the mixer hash of the canonical word; k <= 32.
__global__ void kt_pack_hash_ascii_kernel(const uint8_t* __restrict__ reads,
                                          u32* __restrict__ canon_hi,
                                          u32* __restrict__ canon_lo,
                                          u32* __restrict__ hash_hi,
                                          u32* __restrict__ hash_lo,
                                          uint8_t* __restrict__ valid_out,
                                          int L, int k, int segs, u64 seed) {
  extern __shared__ uint8_t seg[];
  const long long row = blockIdx.x / segs;
  const int p0 = (int)(blockIdx.x % segs) * WIN_THREADS;
  kt_stage_segment(reads, seg, row, p0, WIN_THREADS + k - 1, L, 'N');
  const int p = p0 + threadIdx.x;
  if (p >= L) return;

  bool bases;
  const u64 fw = kt_window64(seg, threadIdx.x, k, &bases);
  const bool valid = bases && p <= L - k;
  const u64 c = kt_canonical64(fw, k);
  const u64 h = kt_mix64((u32)(c >> 32), (u32)c, seed);
  const long long lane = row * L + p;
  canon_hi[lane] = valid ? (u32)(c >> 32) : 0u;
  canon_lo[lane] = valid ? (u32)c : 0u;
  hash_hi[lane] = valid ? (u32)(h >> 32) : 0u;
  hash_lo[lane] = valid ? (u32)h : 0u;
  valid_out[lane] = valid;
}

KT_EXPORT int kt_pack_keys_packed(const void* words, const void* vbits,
                                  void* out_hi, void* out_lo, int B, int L,
                                  int k, void* stream) {
  const long long n = (long long)B * L;
  if (n == 0) return 0;
  const long long blocks = (n + WIN_THREADS - 1) / WIN_THREADS;
  kt_pack_keys_packed_kernel<<<(unsigned)blocks, WIN_THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const u32*)words, (const u32*)vbits, (u32*)out_hi, (u32*)out_lo, n, L,
      k);
  return (int)cudaGetLastError();
}

KT_EXPORT int kt_pack_keys_ascii(const void* reads, void* out_hi,
                                 void* out_lo, int B, int L, int k,
                                 void* stream) {
  if ((long long)B * L == 0) return 0;
  const int segs = (L + WIN_THREADS - 1) / WIN_THREADS;
  const long long blocks = (long long)B * segs;
  const size_t smem = WIN_THREADS + k - 1;
  kt_pack_keys_ascii_kernel<<<(unsigned)blocks, WIN_THREADS, smem,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (u32*)out_hi, (u32*)out_lo, L, k, segs);
  return (int)cudaGetLastError();
}

KT_EXPORT int kt_pack_hash_ascii(const void* reads, void* canon_hi,
                                 void* canon_lo, void* hash_hi,
                                 void* hash_lo, void* valid, int B, int L,
                                 int k, unsigned long long seed,
                                 void* stream) {
  if ((long long)B * L == 0) return 0;
  const int segs = (L + WIN_THREADS - 1) / WIN_THREADS;
  const long long blocks = (long long)B * segs;
  const size_t smem = WIN_THREADS + k - 1;
  kt_pack_hash_ascii_kernel<<<(unsigned)blocks, WIN_THREADS, smem,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (u32*)canon_hi, (u32*)canon_lo, (u32*)hash_hi,
      (u32*)hash_lo, (uint8_t*)valid, L, k, segs, (u64)seed);
  return (int)cudaGetLastError();
}

KT_EXPORT const char* kt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
