// K11: ascending sort of 64-bit keys held as two uint32 planes (hi, lo),
// as unsigned values (uint64)hi << 32 | lo.  No payload.
//
// Replaces kmers_tpu/kernels/sort.py:bitonic_sort_u64 (its Pallas tile
// kernel _tile_sort_kernel and merge pass _intra_pass_kernel).  The TPU
// kernel is a bitonic network because Mosaic has no data-dependent
// addressing; it needs a power-of-two n (count.py pads with all-ones
// keys).  On Hopper the job is a least-significant-digit radix sort: 8
// passes of 8-bit digits over ping-pong buffers, any n, no padding.
//
// Bound: device-memory bytes.  The least traffic is one read and one
// write of the keys (16 B a key); this design moves about 24 B a key per
// pass (a 4 B digit-plane read for the tile histogram, an 8 B read and an
// 8 B write in the scatter) plus one 8 B read for the digit census, so up
// to ~200 B a key.  It skips every pass whose digit is the same for all
// keys (the census says which), which is most passes for short keys.
//
// A pass is three kernels:
//   1. tile histograms: 256 bins in shared memory per RS_TILE-key tile,
//      stored digit-major, hist[d * n_tiles + t];
//   2. an exclusive scan of hist over tiles, one block per digit, and the
//      digit's total;
//   3. a stable scatter: each tile's keys in order, 256 at a time; a key's
//      rank among the equal digits of its warp comes from
//      __match_any_sync, the warps' counts per digit are scanned in warp
//      order in shared memory, and the tile's running count per digit
//      carries across rounds.  Key order within a tile is (round, warp,
//      lane) = index order, and tiles take their offsets in order, so the
//      pass is stable -- which is what makes LSD correct.
// Blocks run in any order (the TPU grid ran in sequence); the cross-tile
// offsets come from the scan pass, not from carried state.

#include "common.cuh"

#define RS_THREADS 256
#define RS_ITEMS 16
#define RS_TILE (RS_THREADS * RS_ITEMS)
#define RS_BINS 256
#define RS_WARPS (RS_THREADS / 32)
#define RS_FULL 0xFFFFFFFFu

// The digit census: hist8[p * 256 + d] = number of keys whose byte p
// (p = 0 least significant) is d, all eight bytes in one read.
__global__ void __launch_bounds__(RS_THREADS)
kt_radix_hist8_kernel(const u32* __restrict__ hi, const u32* __restrict__ lo,
                      long long n, unsigned long long* __restrict__ hist8) {
  __shared__ u32 h[8 * RS_BINS];
  for (int i = threadIdx.x; i < 8 * RS_BINS; i += RS_THREADS) h[i] = 0;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * RS_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * RS_THREADS) {
    const u32 l = lo[i], hh = hi[i];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      atomicAdd(&h[p * RS_BINS + ((l >> (8 * p)) & 0xFFu)], 1u);
      atomicAdd(&h[(p + 4) * RS_BINS + ((hh >> (8 * p)) & 0xFFu)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * RS_BINS; i += RS_THREADS)
    if (h[i]) atomicAdd(&hist8[i], (unsigned long long)h[i]);
}

// Pass step 1: the histogram of one tile's digits (plane >> shift & 0xFF).
__global__ void __launch_bounds__(RS_THREADS)
kt_radix_tile_hist_kernel(const u32* __restrict__ plane, long long n,
                          int shift, u32* __restrict__ hist, int n_tiles) {
  __shared__ u32 h[RS_BINS];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * RS_TILE;
#pragma unroll 4
  for (int r = 0; r < RS_ITEMS; ++r) {
    const long long i = t0 + r * RS_THREADS + threadIdx.x;
    if (i < n) atomicAdd(&h[(plane[i] >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  hist[(long long)threadIdx.x * n_tiles + blockIdx.x] = h[threadIdx.x];
}

// Pass step 2: exclusive scan of digit blockIdx.x's row of tile counts,
// in place, and the digit's total.
__global__ void __launch_bounds__(RS_THREADS)
kt_radix_scan_kernel(u32* __restrict__ hist, int n_tiles,
                     u32* __restrict__ digit_total) {
  __shared__ u32 warp_sum[RS_WARPS];
  __shared__ u32 carry;
  u32* row = hist + (long long)blockIdx.x * n_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int c0 = 0; c0 < n_tiles; c0 += RS_THREADS) {
    const int i = c0 + threadIdx.x;
    const u32 v = i < n_tiles ? row[i] : 0u;
    u32 x = v;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const u32 up = __shfl_up_sync(RS_FULL, x, s);
      if (lane >= s) x += up;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      u32 w = lane < RS_WARPS ? warp_sum[lane] : 0u;
#pragma unroll
      for (int s = 1; s < RS_WARPS; s <<= 1) {
        const u32 up = __shfl_up_sync(RS_FULL, w, s);
        if (lane >= s) w += up;
      }
      if (lane < RS_WARPS) warp_sum[lane] = w;    // inclusive
    }
    __syncthreads();
    if (i < n_tiles) row[i] = carry + (warp ? warp_sum[warp - 1] : 0u) + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[RS_WARPS - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) digit_total[blockIdx.x] = carry;
}

// Pass step 3: the stable scatter of one tile (see the header).
__global__ void __launch_bounds__(RS_THREADS)
kt_radix_scatter_kernel(const u32* __restrict__ src_hi,
                        const u32* __restrict__ src_lo, long long n, int shift,
                        const u32* __restrict__ hist, int n_tiles,
                        const u32* __restrict__ digit_total,
                        u32* __restrict__ dst_hi, u32* __restrict__ dst_lo) {
  __shared__ u32 next[RS_BINS];               // the tile's next slot per digit
  __shared__ u32 scan[RS_BINS];
  __shared__ u32 wcount[RS_WARPS][RS_BINS];   // per warp and digit
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // digit bases: exclusive scan of the totals (Hillis-Steele, 8 steps)
  const u32 total = digit_total[tid];
  scan[tid] = total;
  __syncthreads();
#pragma unroll
  for (int s = 1; s < RS_BINS; s <<= 1) {
    const u32 add = tid >= s ? scan[tid - s] : 0u;
    __syncthreads();
    scan[tid] += add;
    __syncthreads();
  }
  next[tid] = scan[tid] - total + hist[(long long)tid * n_tiles + blockIdx.x];
  const long long t0 = (long long)blockIdx.x * RS_TILE;
  const bool hi_digit = shift >= 32;
  const int sh = shift & 31;
  for (int r = 0; r < RS_ITEMS; ++r) {
#pragma unroll
    for (int w = 0; w < RS_WARPS; ++w) wcount[w][tid] = 0;
    __syncthreads();
    const long long i = t0 + r * RS_THREADS + tid;
    const bool live = i < n;
    u32 kh = 0, kl = 0, d = RS_BINS;          // RS_BINS: no key here
    if (live) {
      kh = src_hi[i];
      kl = src_lo[i];
      d = ((hi_digit ? kh : kl) >> sh) & 0xFFu;
    }
    const u32 peers = __match_any_sync(RS_FULL, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (live && rank == 0) wcount[warp][d] = __popc(peers);
    __syncthreads();
    {   // thread tid owns digit tid: warp offsets in warp order
      u32 run = next[tid];
#pragma unroll
      for (int w = 0; w < RS_WARPS; ++w) {
        const u32 c = wcount[w][tid];
        wcount[w][tid] = run;
        run += c;
      }
      next[tid] = run;
    }
    __syncthreads();
    if (live) {
      const u32 at = wcount[warp][d] + rank;
      dst_hi[at] = kh;
      dst_lo[at] = kl;
    }
    __syncthreads();
  }
}

static unsigned kt_radix_grid(long long n) {
  const long long blocks = (n + RS_THREADS - 1) / RS_THREADS;
  return (unsigned)(blocks < 132 * 8 ? blocks : 132 * 8);
}

KT_EXPORT int kt_radix_tile() { return RS_TILE; }

// hist8: 8 * 256 int64 lanes, zeroed by the caller.
KT_EXPORT int kt_radix_hist8(const void* hi, const void* lo, long long n,
                             void* hist8, void* stream) {
  if (n == 0) return 0;
  kt_radix_hist8_kernel<<<kt_radix_grid(n), RS_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const u32*)hi, (const u32*)lo, n, (unsigned long long*)hist8);
  return (int)cudaGetLastError();
}

// One LSD pass on the digit at bit `shift` (0, 8, ..., 56): src -> dst.
// hist: 256 * ceil(n / kt_radix_tile()) int32 lanes; digit_total: 256.
// n < 2^31.
KT_EXPORT int kt_radix_pass(const void* src_hi, const void* src_lo,
                            long long n, int shift, void* hist,
                            void* digit_total, void* dst_hi, void* dst_lo,
                            void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (int)((n + RS_TILE - 1) / RS_TILE);
  const u32* plane = (const u32*)(shift >= 32 ? src_hi : src_lo);
  kt_radix_tile_hist_kernel<<<n_tiles, RS_THREADS, 0, st>>>(
      plane, n, shift & 31, (u32*)hist, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kt_radix_scan_kernel<<<RS_BINS, RS_THREADS, 0, st>>>(
      (u32*)hist, n_tiles, (u32*)digit_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kt_radix_scatter_kernel<<<n_tiles, RS_THREADS, 0, st>>>(
      (const u32*)src_hi, (const u32*)src_lo, n, shift, (const u32*)hist,
      n_tiles, (const u32*)digit_total, (u32*)dst_hi, (u32*)dst_lo);
  return (int)cudaGetLastError();
}
