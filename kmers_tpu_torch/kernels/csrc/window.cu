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
// All three should be bound by device-memory bytes: 8 (K5: 17) bytes
// written a lane against 0.375 (K1) or 1 (K2, K5) read.  K2 and K5 run
// one thread per output lane, so each 32-bit store of a warp is one
// contiguous 128-byte line, and stage a row segment plus its (k-1)-byte
// halo in shared memory once, so every input byte crosses device memory
// once.  The TPU kernel's q-layout, rolls, L % 128 limit and block-row
// limit were workarounds for Mosaic and have no counterpart here: the
// unit table is a multiset, so p-order serves it for any L % 32 == 0.
//
// K1 first ran one thread a lane too.  Each lane paid a 64-bit division
// by L for its row, five bounds-checked loads, its window rebuilt from
// three code words and the 5-step reverse-complement ladder, some 150-200
// integer instructions a lane.  Now a 2-D grid gives the row (blockIdx.y,
// a warp a row) and the 256-lane chunk (blockIdx.x): the warp loads the
// chunk's 16 code words plus 2 of halo and its 8 validity words plus 1 in
// one coalesced load each, and each thread makes two runs of 4 lanes
// (from 4 t and from 128 + 4 t), taking each run's 3 + 2 words by
// __shfl_sync.  It builds a run's first forward word and reverse
// complement once, then rolls both a base at a time (fw = fw >> 2 |
// c << 2(k-1), rc = (rc << 2 | 3 - c) & mask), takes min(fw, rc) and tests
// the k validity bits in a 64-bit funnel of the bitmap words.  Each run is
// one 16-byte store a plane, so a warp's store covers 512 contiguous
// bytes: 8 consecutive lanes a thread, stored as two 16-byte halves 32
// bytes apart, wrote half sectors and were slower than the arithmetic.

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

#define K1_RUN 4                     // lanes a thread in each half
#define K1_CHUNK 256                 // lanes a warp: one row's chunk
#define K1_ROWS 8                    // warps (rows) a block

// K1: a [B, L] batch, L % 32 == 0, 1 <= k <= 31.  Warp (blockIdx.y,
// threadIdx.y) walks rows; in each it makes the 256-lane chunk blockIdx.x,
// thread t the 4 lanes from 4 t and the 4 from 128 + 4 t, so that each
// 16-byte store of the warp covers 512 contiguous bytes.
__global__ void __launch_bounds__(32 * K1_ROWS)
kt_pack_keys_packed_kernel(const u32* __restrict__ words,
                           const u32* __restrict__ vbits,
                           u32* __restrict__ out_hi, u32* __restrict__ out_lo,
                           int B, int L, int k) {
  const int lane = threadIdx.x;
  const int nw = L >> 4, nv = L >> 5;
  const int cw0 = blockIdx.x * (K1_CHUNK / 16);
  const int vw0 = blockIdx.x * (K1_CHUNK / 32);
  const u64 mask = (1ull << (2 * k)) - 1;
  const u64 need = (1ull << k) - 1;
  for (long long row = (long long)blockIdx.y * K1_ROWS + threadIdx.y; row < B;
       row += (long long)gridDim.y * K1_ROWS) {
    // the chunk's words plus halo, one coalesced load each (0 past the row)
    const u32* w = words + row * nw;
    const u32* v = vbits + row * nv;
    const u32 my_w = lane < 18 && cw0 + lane < nw ? w[cw0 + lane] : 0u;
    const u32 my_v = lane < 9 && vw0 + lane < nv ? v[vw0 + lane] : 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = 128 * h + K1_RUN * lane;           // first lane in chunk
      const int p0 = blockIdx.x * K1_CHUNK + c0;
      const int j = c0 >> 4, vj = c0 >> 5;             // its words
      const u32 w0 = __shfl_sync(0xFFFFFFFFu, my_w, j);
      const u32 w1 = __shfl_sync(0xFFFFFFFFu, my_w, j + 1);
      const u32 w2 = __shfl_sync(0xFFFFFFFFu, my_w, j + 2);
      const u64 vw = (u64)__shfl_sync(0xFFFFFFFFu, my_v, vj)
                     | (u64)__shfl_sync(0xFFFFFFFFu, my_v, vj + 1) << 32;
      if (p0 >= L) continue;

      // bases p0 .. p0+31 (a) and from p0+32 (x); bases p0+k .. p0+k+2,
      // the ones rolled in, in the low 6 bits of nxt (2 <= 2k <= 62)
      const int sh = 2 * (c0 & 15);
      const u64 w01 = kt_word(w1, w0);
      const u64 a = sh ? (w01 >> sh) | ((u64)w2 << (64 - sh)) : w01;
      const u64 x = w2 >> sh;
      const u64 nxt = (a >> (2 * k)) | (x << (64 - 2 * k));
      u64 fw = a & mask;
      u64 rc = kt_revcomp64(fw, k);
      const int vq = c0 & 31;
      u32 hi[K1_RUN], lo[K1_RUN];
#pragma unroll
      for (int i = 0; i < K1_RUN; ++i) {
        if (i) {
          const u64 c = (nxt >> (2 * (i - 1))) & 3;
          fw = (fw >> 2) | (c << (2 * k - 2));
          rc = ((rc << 2) | (3 - c)) & mask;
        }
        const bool valid =
            p0 + i <= L - k && ((vw >> (vq + i)) & need) == need;
        const u64 canon = fw < rc ? fw : rc;
        hi[i] = valid ? (u32)(canon >> 32) : KT_INVALID_HI;
        lo[i] = valid ? (u32)canon : 0u;
      }
      *reinterpret_cast<uint4*>(out_hi + row * L + p0) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(out_lo + row * L + p0) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
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
  if ((long long)B * L == 0) return 0;
  const long long rows = (B + K1_ROWS - 1) / K1_ROWS;
  const dim3 grid((L + K1_CHUNK - 1) / K1_CHUNK,
                  (unsigned)(rows < 65535 ? rows : 65535));
  kt_pack_keys_packed_kernel<<<grid, dim3(32, K1_ROWS), 0,
                               (cudaStream_t)stream>>>(
      (const u32*)words, (const u32*)vbits, (u32*)out_hi, (u32*)out_lo, B, L,
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
