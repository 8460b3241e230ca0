// Shared definitions of the port's CUDA kernels.
//
// Every kernel reads and writes int32 tensors from PyTorch that hold
// uint32 bit patterns; the C entry points take them as uint32_t.  Each
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

#define KT_EXPORT extern "C" __attribute__((visibility("default")))

// The folded layout of a unit key: bit 31 of hi set = invalid lane, and
// an invalid lane is exactly (0x80000000, 0).
#define KT_INVALID_HI 0x80000000u

__device__ __forceinline__ u64 kt_word(u32 hi, u32 lo) {
  return ((u64)hi << 32) | (u64)lo;
}

// Reverse complement of a k-base word, 1 <= k <= 32: complement, the
// 5-step swap ladder (strides 2, 4, 8, 16, 32), shift down to k bases.
__device__ __forceinline__ u64 kt_revcomp64(u64 fw, int k) {
  u64 x = ~fw;
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * k);
}

// The full 32-base reversal of a 64-bit word (kt_revcomp64 without the
// complement and the shift).
__device__ __forceinline__ u64 kt_reverse_bases64(u64 x) {
  return kt_revcomp64(~x, 32);
}

// One ASCII byte -> its 2-bit code (A=0 C=1 G=2 T=3, any case; garbage
// for other bytes) and whether it is one of ACGTacgt
// (kmers_tpu/ops/encoding.py).
__device__ __forceinline__ u32 kt_code(u32 c, bool* ok) {
  const u32 internal = (c >> 1) & 3u;          // A=0 C=1 T=2 G=3
  const u32 lower = c | 0x20u;
  *ok = lower == 'a' || lower == 'c' || lower == 'g' || lower == 't';
  return internal ^ (internal >> 1);
}

// The not-a-base flag of a staged code byte (kt_code_flag4).
#define KT_NOT_BASE 4

// Four ASCII bytes at once: each byte's 2-bit code, plus KT_NOT_BASE where
// it is not one of ACGTacgt (kt_code, byte by byte).
__device__ __forceinline__ u32 kt_code_flag4(u32 w) {
  const u32 internal = (w >> 1) & 0x03030303u;   // A=0 C=1 T=2 G=3
  const u32 lower = w | 0x20202020u;
  const u32 ok = __vcmpeq4(lower, 0x61616161u) | __vcmpeq4(lower, 0x63636363u) |
                 __vcmpeq4(lower, 0x67676767u) | __vcmpeq4(lower, 0x74747474u);
  return (internal ^ ((internal >> 1) & 0x01010101u)) | (~ok & 0x04040404u);
}

// Stage the THREADS * RUN bytes of the flattened batch (n bytes) from t0,
// plus the (k-1)-byte halo, as code bytes (kt_code_flag4) in seg, by the
// THREADS threads tid = 0 .. THREADS - 1 (a block's, or a warp's lanes):
// one 8-byte load a thread where the tile and its halo lie inside the
// batch and the batch is 8-byte aligned, else byte by byte with 'A'
// (code 0, a base) past n.  1 <= k <= THREADS + 1; the caller syncs.
template <int THREADS, int RUN>
__device__ __forceinline__ void kt_stage_codes(const uint8_t* reads,
                                               uint8_t* seg, long long t0,
                                               long long n, int k, int tid) {
  static_assert(RUN == 8, "a run of 8 lanes: one 8-byte load a thread");
  constexpr int TILE = THREADS * RUN;
  if (t0 + TILE + k - 1 <= n && ((uintptr_t)reads & 7) == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(reads + t0 + 8 * tid);
    *reinterpret_cast<uint2*>(&seg[8 * tid]) =
        make_uint2(kt_code_flag4(w.x), kt_code_flag4(w.y));
    if (tid < k - 1)
      seg[TILE + tid] = (uint8_t)kt_code_flag4(reads[t0 + TILE + tid]);
  } else {
    for (int i = tid; i < TILE + k - 1; i += THREADS)
      seg[i] = (uint8_t)kt_code_flag4(t0 + i < n ? reads[t0 + i] : 'A');
  }
}

// Stage a thread's NP x RUN output words (RUN consecutive lanes from lane
// b of the tile) in shared memory, as 16-byte stores.
template <int TILE, int NP, int RUN>
__device__ __forceinline__ void kt_put_run(u32 (*planes)[TILE],
                                           const u32 (&out)[NP][RUN], int b) {
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < RUN; i += 4)
      *reinterpret_cast<uint4*>(&planes[j][b + i]) =
          make_uint4(out[j][i], out[j][i + 1], out[j][i + 2], out[j][i + 3]);
}

// Write NP staged planes of a TILE-lane tile to lanes t0 .. of dst (n
// lanes in all), by the THREADS threads tid = 0 .. THREADS - 1, as 16-byte
// stores, each warp store on 512 contiguous bytes, with a scalar tail at
// n.  The destinations are fresh allocations, so 16-byte aligned; the
// caller syncs before.
template <int THREADS, int TILE, int NP>
__device__ __forceinline__ void kt_store_tile(const u32 (*planes)[TILE],
                                              u32* const (&dst)[NP],
                                              long long t0, long long n,
                                              int tid) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    for (int q = tid; q < TILE / 4; q += THREADS) {
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

// The mixer hash of kmers_tpu/core/u64.py (mix_hash): 32-bit 'lowbias32'
// rounds, every multiply kept to its low 32 bits.
__device__ __forceinline__ u32 kt_mix32(u32 x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ u64 kt_mix64(u32 hi, u32 lo, u64 seed) {
  const u32 s_lo = (u32)seed, s_hi = (u32)(seed >> 32);
  const u32 h_lo = kt_mix32(lo ^ kt_mix32(hi ^ s_lo));
  const u32 h_hi = kt_mix32(hi ^ kt_mix32(lo ^ s_hi ^ 0x9E3779B9u));
  return kt_word(h_hi, h_lo);
}
