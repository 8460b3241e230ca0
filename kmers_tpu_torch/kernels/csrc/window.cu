// Window kernels: reads -> canonical k-mer words (1 <= k <= 32).
//
// Replaces three Pallas functions of kmers_tpu/kernels/window.py:
//   K1 pack_canonical_keys_packed  (packed 2-bit words + validity bitmaps)
//   K2 pack_canonical_keys         (ASCII bytes)
//   K5 pack_canonical_hash         (ASCII bytes, canonical word + hash)
// Output planes are [B, L], lane p = the window that starts at base p
// ("p-order").  K1/K2 (k <= 31) emit two int32 planes: a valid lane holds
// the canonical word (hi, lo) (K2 at stage "pack": the forward word), an
// invalid lane is exactly (0x80000000, 0)
// -- the invalid flag folded into bit 31 of hi, structurally clear for
// k <= 31.  K5 (k <= 32) emits canon hi/lo, hash hi/lo and a valid byte,
// the four words zero on invalid lanes (window.py:177-186).
//
// All three should be bound by device-memory bytes: 8 (K5: 17) bytes
// written a lane against 0.375 (K1) or 1 (K2, K5) read.  The TPU kernel's
// q-layout, rolls, L % 128 limit and block-row limit were workarounds for
// Mosaic and have no counterpart here: the unit table is a multiset, so
// p-order serves it for any L % 32 == 0.
//
// K2 first ran one thread a lane, at 7 % of its 9-byte-a-lane memory
// bound: a block staged a row segment plus its (k-1)-byte halo, and each
// thread rebuilt its lane's whole window from k bytes (four compares a
// byte) and ran the 5-step reverse-complement ladder, some 10k + 25
// integer operations a lane.  Now it takes K7's rolled runs
// (window_wide.cu) in 64 bits, in tiles of one warp.  A warp takes
// K2_WARP_TILE consecutive lanes of the flattened [B, L] batch and stages
// them with their halo as code bytes (kt_stage_codes: one 8-byte load a
// lane, each byte decoded once).  Each lane builds the first window of its
// run of K2_RUN lanes, from four 8-byte loads of those codes, and that
// window's reverse complement once, then rolls the other lanes in a base
// at a time (kt_roll_canonical64), some 12 operations a lane.  A lane is
// valid where the bases counted since the last non-base byte reach k and
// its base p in its row is at most L - k: a run may cross into the next
// row, whose bytes then fill only lanes past L - k, which fold to the
// invalid constant whatever they hold, so any L >= k works.  The two
// planes are staged in the warp's shared memory and leave as 16-byte
// stores of its contiguous lane range (kt_store_tile), each store on 512
// contiguous bytes: K1's direct 16-byte stores from a row chunk would need
// L % 4 == 0, and K2 takes any L.  No warp waits for another: block tiles
// as K7's, staged and stored across the block between two barriers, were
// slower, and runs of 16 lanes no faster (PERF.md, section 6).
//
// K5 ran that one-lane body too, at 14 % of its 18-byte-a-lane bound.
// Now it takes K2's warp tiles and rolled runs, k <= 32, and hashes each
// lane's canonical word (kt_mix64: 4 kt_mix32 rounds, 8 multiplies a lane,
// which cannot be rolled); its four words are zero on invalid lanes, so a
// run that crosses into the next row is sound as in K2 and any L >= k
// works.  The four word planes leave through the warp's shared memory as
// K2's two do (4 x 1 KB a warp, 35,072 B a block), the valid bytes as one
// 8-byte store a thread.  At [2048, 1024], k = 31, it reaches about 70 %
// of its memory bound by the profiler, 4.1x the one-lane body by the
// events; block tiles as K8's (128 threads, 1024 lanes between two
// barriers) were some 7 % slower (PERF.md, section 6).
//
// Stage "pack" of K1 and K2 (the roofline ablation's compute-light arm
// of kmers_tpu/kernels/window.py) folds the forward word in place of the
// canonical one: a template flag of each kernel, so the reverse
// complement is never built and the stage-"canon" instances are
// unchanged.
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

#define K1_RUN 4                     // lanes a thread in each half
#define K1_CHUNK 256                 // lanes a warp: one row's chunk
#define K1_ROWS 8                    // warps (rows) a block

// K1: a [B, L] batch, L % 32 == 0, 1 <= k <= 31.  Warp (blockIdx.y,
// threadIdx.y) walks rows; in each it makes the 256-lane chunk blockIdx.x,
// thread t the 4 lanes from 4 t and the 4 from 128 + 4 t, so that each
// 16-byte store of the warp covers 512 contiguous bytes.  CANON false:
// stage "pack", the forward words.
template <bool CANON>
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
      u64 rc = CANON ? kt_revcomp64(fw, k) : 0;
      const int vq = c0 & 31;
      u32 hi[K1_RUN], lo[K1_RUN];
#pragma unroll
      for (int i = 0; i < K1_RUN; ++i) {
        if (i) {
          const u64 c = (nxt >> (2 * (i - 1))) & 3;
          fw = (fw >> 2) | (c << (2 * k - 2));
          if (CANON) rc = ((rc << 2) | (3 - c)) & mask;
        }
        const bool valid =
            p0 + i <= L - k && ((vw >> (vq + i)) & need) == need;
        const u64 canon = !CANON || fw < rc ? fw : rc;
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

// The 2-bit codes of 8 staged code bytes (kt_code_flag4), packed into
// 16 bits, byte 0's lowest.
__device__ __forceinline__ u64 kt_pack_codes8(u64 w) {
  w &= 0x0303030303030303ull;
  w = (w | (w >> 6)) & 0x000F000F000F000Full;
  w = (w | (w >> 12)) & 0x000000FF000000FFull;
  return (w | (w >> 24)) & 0xFFFFull;
}

// The not-a-base flags of 8 staged code bytes as 8 bits, byte 0's lowest.
__device__ __forceinline__ u32 kt_pack_flags8(u64 w) {
  w = (w >> 2) & 0x0101010101010101ull;
  w = (w | (w >> 7)) & 0x0003000300030003ull;
  w = (w | (w >> 14)) & 0x0000000F0000000Full;
  return (u32)((w | (w >> 28)) & 0xFFull);
}

#define K2_RUN 8                        // lanes a thread: 1 built, 7 rolled
#define K2_WARP_TILE (32 * K2_RUN)      // lanes a warp: its own tile
#define K2_WARPS 8                      // warps a block

// The rolled narrow body of K2 and K5, 1 <= k <= 32: the canonical words
// (CANON false: the forward words, stage "pack") of the RUN lanes whose
// windows start at seg[b], seg[b+1], ... (code bytes, kt_stage_codes), the
// first at base p of its row, and whether each is valid (its k bytes are
// bases and its base in its row is at most L - k).  The first window and
// its reverse complement are built once; each later lane rolls in one base
// (fw = fw >> 2 | c << 2(k-1), rc = (rc << 2 | 3 - c) & mask).
template <int RUN, bool CANON = true>
__device__ __forceinline__ void kt_roll_canonical64(const uint8_t* seg, int b,
                                                    int k, int p, int L,
                                                    u64 (&canon)[RUN],
                                                    bool (&valid)[RUN]) {
  const u64 mask = ~0ull >> (64 - 2 * k);
  // the first window from staged bytes b .. b + 31 (b % 8 == 0) in four
  // 8-byte loads: the codes packed 8 at a time, the not-a-base flags as a
  // bit mask whose highest bit under k gives the bases since the last
  // non-base byte
  u64 fw = 0;
  u32 flags = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const u64 w = *reinterpret_cast<const u64*>(seg + b + 8 * q);
    fw |= kt_pack_codes8(w) << (16 * q);
    flags |= kt_pack_flags8(w) << (8 * q);
  }
  fw &= mask;
  int run = k - 32 + __clz(flags & (~0u >> (32 - k)));
  u64 rc = kt_revcomp64(fw, k);
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    if (i) {                        // roll in base b + k - 1 + i
      const u32 e = seg[b + k - 1 + i];
      const u64 c = e & 3u;
      fw = (fw >> 2) | (c << (2 * k - 2));
      rc = ((rc << 2) | (3 - c)) & mask;
      run = e & KT_NOT_BASE ? 0 : run + 1;
      if (++p == L) p = 0;
    }
    canon[i] = !CANON || fw < rc ? fw : rc;
    valid[i] = run >= k && p <= L - k;
  }
}

// K2: warp w of block x = the K2_WARP_TILE consecutive lanes of the
// flattened [B, L] batch (n lanes) from (K2_WARPS x + w) K2_WARP_TILE,
// lane t the lanes K2_RUN t .. K2_RUN t + K2_RUN - 1 of it; 1 <= k <= 31,
// so bit 31 of hi is clear on a valid lane.  The warps share no data, so
// each stages, rolls and stores without waiting for the others.  CANON
// false: stage "pack".
template <bool CANON>
__global__ void __launch_bounds__(32 * K2_WARPS)
kt_pack_keys_ascii_kernel(const uint8_t* __restrict__ reads,
                          u32* __restrict__ out_hi, u32* __restrict__ out_lo,
                          long long n, int L, int k) {
  // code | NOT_BASE bytes, then the two planes, of each warp's tile
  __shared__ __align__(16) uint8_t segs[K2_WARPS][K2_WARP_TILE + 32];
  __shared__ __align__(16) u32 planes[K2_WARPS][2][K2_WARP_TILE];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t0 = ((long long)blockIdx.x * K2_WARPS + w) * K2_WARP_TILE;
  if (t0 >= n) return;
  kt_stage_codes<32, K2_RUN>(reads, segs[w], t0, n, k, lane);
  __syncwarp();

  const int b = K2_RUN * lane;
  u64 canon[K2_RUN];
  bool valid[K2_RUN];
  kt_roll_canonical64<K2_RUN, CANON>(segs[w], b, k, (int)((t0 + b) % L), L,
                                     canon, valid);
  u32 out[2][K2_RUN];
#pragma unroll
  for (int i = 0; i < K2_RUN; ++i) {
    out[0][i] = valid[i] ? (u32)(canon[i] >> 32) : KT_INVALID_HI;
    out[1][i] = valid[i] ? (u32)canon[i] : 0u;
  }
  kt_put_run(planes[w], out, b);
  __syncwarp();
  u32* const dst[2] = {out_hi, out_lo};
  kt_store_tile<32, K2_WARP_TILE, 2>(planes[w], dst, t0, n, lane);
}

// K5, 1 <= k <= 32: the tiles of K2 (warp w of block x, K2_WARP_TILE
// lanes from (K2_WARPS x + w) K2_WARP_TILE, lane t a run of K2_RUN lanes),
// each lane's canonical word and its mixer hash, the four words zero on
// invalid lanes, and a valid byte.
__global__ void __launch_bounds__(32 * K2_WARPS)
kt_pack_hash_ascii_kernel(const uint8_t* __restrict__ reads,
                          u32* __restrict__ canon_hi,
                          u32* __restrict__ canon_lo,
                          u32* __restrict__ hash_hi,
                          u32* __restrict__ hash_lo,
                          uint8_t* __restrict__ valid_out, long long n, int L,
                          int k, u64 seed) {
  // code | NOT_BASE bytes, then the four word planes, of each warp's tile
  __shared__ __align__(16) uint8_t segs[K2_WARPS][K2_WARP_TILE + 32];
  __shared__ __align__(16) u32 planes[K2_WARPS][4][K2_WARP_TILE];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t0 = ((long long)blockIdx.x * K2_WARPS + w) * K2_WARP_TILE;
  if (t0 >= n) return;
  kt_stage_codes<32, K2_RUN>(reads, segs[w], t0, n, k, lane);
  __syncwarp();

  const int b = K2_RUN * lane;
  u64 canon[K2_RUN];
  bool valid[K2_RUN];
  kt_roll_canonical64<K2_RUN>(segs[w], b, k, (int)((t0 + b) % L), L, canon,
                              valid);
  u32 out[4][K2_RUN];
  u64 vbytes = 0;                   // lane i's valid byte in bits 8i..
#pragma unroll
  for (int i = 0; i < K2_RUN; ++i) {
    const u64 h = kt_mix64((u32)(canon[i] >> 32), (u32)canon[i], seed);
    out[0][i] = valid[i] ? (u32)(canon[i] >> 32) : 0u;
    out[1][i] = valid[i] ? (u32)canon[i] : 0u;
    out[2][i] = valid[i] ? (u32)(h >> 32) : 0u;
    out[3][i] = valid[i] ? (u32)h : 0u;
    vbytes |= (u64)valid[i] << (8 * i);
  }
  const long long f = t0 + b;
  if (f + K2_RUN <= n) {
    *reinterpret_cast<uint2*>(valid_out + f) =
        make_uint2((u32)vbytes, (u32)(vbytes >> 32));
  } else {
    for (int i = 0; f + i < n; ++i)
      valid_out[f + i] = (uint8_t)(vbytes >> (8 * i));
  }
  kt_put_run(planes[w], out, b);
  __syncwarp();
  u32* const dst[4] = {canon_hi, canon_lo, hash_hi, hash_lo};
  kt_store_tile<32, K2_WARP_TILE, 4>(planes[w], dst, t0, n, lane);
}

// pack: 0 stage "canon", 1 stage "pack".
KT_EXPORT int kt_pack_keys_packed(const void* words, const void* vbits,
                                  void* out_hi, void* out_lo, int B, int L,
                                  int k, int pack, void* stream) {
  if ((long long)B * L == 0) return 0;
  const long long rows = (B + K1_ROWS - 1) / K1_ROWS;
  const dim3 grid((L + K1_CHUNK - 1) / K1_CHUNK,
                  (unsigned)(rows < 65535 ? rows : 65535));
  auto kernel = pack ? kt_pack_keys_packed_kernel<false>
                     : kt_pack_keys_packed_kernel<true>;
  kernel<<<grid, dim3(32, K1_ROWS), 0, (cudaStream_t)stream>>>(
      (const u32*)words, (const u32*)vbits, (u32*)out_hi, (u32*)out_lo, B, L,
      k);
  return (int)cudaGetLastError();
}

// pack: 0 stage "canon", 1 stage "pack".
KT_EXPORT int kt_pack_keys_ascii(const void* reads, void* out_hi,
                                 void* out_lo, int B, int L, int k, int pack,
                                 void* stream) {
  const long long n = (long long)B * L;
  if (n == 0) return 0;
  const long long block_lanes = K2_WARPS * K2_WARP_TILE;
  auto kernel = pack ? kt_pack_keys_ascii_kernel<false>
                     : kt_pack_keys_ascii_kernel<true>;
  kernel<<<(unsigned)((n + block_lanes - 1) / block_lanes), 32 * K2_WARPS, 0,
           (cudaStream_t)stream>>>((const uint8_t*)reads, (u32*)out_hi,
                                   (u32*)out_lo, n, L, k);
  return (int)cudaGetLastError();
}

KT_EXPORT int kt_pack_hash_ascii(const void* reads, void* canon_hi,
                                 void* canon_lo, void* hash_hi,
                                 void* hash_lo, void* valid, int B, int L,
                                 int k, unsigned long long seed,
                                 void* stream) {
  const long long n = (long long)B * L;
  if (n == 0) return 0;
  const long long block_lanes = K2_WARPS * K2_WARP_TILE;
  kt_pack_hash_ascii_kernel<<<(unsigned)((n + block_lanes - 1) / block_lanes),
                              32 * K2_WARPS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (u32*)canon_hi, (u32*)canon_lo, (u32*)hash_hi,
      (u32*)hash_lo, (uint8_t*)valid, n, L, k, (u64)seed);
  return (int)cudaGetLastError();
}

KT_EXPORT const char* kt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
