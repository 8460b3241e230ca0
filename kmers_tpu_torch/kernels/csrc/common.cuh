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
