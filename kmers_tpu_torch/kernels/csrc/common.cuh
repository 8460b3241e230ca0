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

// Stage one row segment of a [B, L] byte batch plus its (k-1)-byte halo
// in shared memory: seg[i] = byte p0 + i of row `row`, `fill` past L.
// Ends with __syncthreads().
__device__ __forceinline__ void kt_stage_segment(const uint8_t* reads,
                                                 uint8_t* seg, long long row,
                                                 int p0, int n, int L,
                                                 uint8_t fill) {
  const uint8_t* rd = reads + row * L;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = p0 + i;
    seg[i] = p < L ? rd[p] : fill;
  }
  __syncthreads();
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
