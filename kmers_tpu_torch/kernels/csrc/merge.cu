// Consolidation kernels: the streaming merge of the count table with the
// sorted pending keys, and the stable compaction of run starts.
//
// Replaces two Pallas functions of kmers_tpu/kernels/merge.py:
//   K3 merge_sorted      (_merge_sorted_impl at nk=2, _merge_kernel_n,
//                         _merge_path_search_n, _bitonic_merge_n)
//   K4 compress_flagged  (_compress_kernel)
//
// Both are bound by device-memory bytes: K3 moves 20 B in and 12 B out
// per output lane and K4 some 13 B in and up to 12 B out, against a
// handful of compares each.  The design moves each byte once, in
// coalesced lines:
//
// K3 merge path (Green et al.).  A small kernel splits the output into
// MERGE_TILE-lane ranges by binary search on the diagonals; a block then
// loads its A and B windows (together exactly its output range) into
// shared memory with coalesced reads, each thread finds its own
// MERGE_ITEMS-lane sub-range by a second search in shared memory and
// merges it sequentially, and the block writes its tile back through
// shared memory, again coalesced.  The TPU kernel sorted a 2*tile bitonic
// window per grid step because Mosaic has no data-dependent indexing;
// here each thread simply walks both windows.  Order: unsigned (hi, lo),
// A before B on equal keys.  B weight = (hi >> 31) ^ 1.  The output is
// exactly nA + nB lanes long (no pad lanes).
//
// K4 compaction.  A first kernel counts the kept lanes of each
// COMPRESS_THREADS-lane block (__syncthreads_count); the wrapper takes an
// exclusive cumsum over blocks (as merge.py:303-305 does outside its
// kernel); the second kernel ranks each kept lane inside its block by a
// warp ballot plus a shuffle scan of the warp totals and writes it at
// offs[block] + rank, so kept lanes stay in order.  The TPU kernel
// carried a partial row between sequential grid steps; blocks here run in
// any order, so the cross-block offsets come from the count pass.

#include "common.cuh"

#define MERGE_THREADS 256
#define MERGE_ITEMS 8
#define MERGE_TILE (MERGE_THREADS * MERGE_ITEMS)
#define COMPRESS_THREADS 1024

// Number of A lanes among the first d lanes of the merged output: the
// largest a with A[a-1] <= B[d-a] (A-first ties), a in
// [max(0, d-nB), min(d, nA)].
template <typename KeyA, typename KeyB>
__device__ __forceinline__ long long kt_merge_path(KeyA ka, long long na,
                                                   KeyB kb, long long nb,
                                                   long long d) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ka(mid) <= kb(d - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void kt_merge_partition_kernel(const u32* __restrict__ a_hi,
                                          const u32* __restrict__ a_lo,
                                          long long na,
                                          const u32* __restrict__ b_hi,
                                          const u32* __restrict__ b_lo,
                                          long long nb, long long* part,
                                          long long n_parts) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_parts) return;
  const long long n = na + nb;
  long long d = t * MERGE_TILE;
  if (d > n) d = n;
  part[t] = kt_merge_path([&](long long i) { return kt_word(a_hi[i], a_lo[i]); }, na,
                          [&](long long i) { return kt_word(b_hi[i], b_lo[i]); }, nb,
                          d);
}

__global__ void __launch_bounds__(MERGE_THREADS)
kt_merge_kernel(const u32* __restrict__ a_hi, const u32* __restrict__ a_lo,
                const u32* __restrict__ a_w, long long na,
                const u32* __restrict__ b_hi, const u32* __restrict__ b_lo,
                long long nb, const long long* __restrict__ part,
                u32* __restrict__ o_hi, u32* __restrict__ o_lo,
                u32* __restrict__ o_w) {
  __shared__ u32 sa_hi[MERGE_TILE], sa_lo[MERGE_TILE], sa_w[MERGE_TILE];
  __shared__ u32 sb_hi[MERGE_TILE], sb_lo[MERGE_TILE];
  const long long n = na + nb;
  const long long d0 = (long long)blockIdx.x * MERGE_TILE;
  const long long d1 = d0 + MERGE_TILE < n ? d0 + MERGE_TILE : n;
  const long long a0 = part[blockIdx.x], a1 = part[blockIdx.x + 1];
  const long long b0 = d0 - a0;
  const int wa = (int)(a1 - a0), wb = (int)((d1 - a1) - b0);
  for (int i = threadIdx.x; i < wa; i += MERGE_THREADS) {
    sa_hi[i] = a_hi[a0 + i];
    sa_lo[i] = a_lo[a0 + i];
    sa_w[i] = a_w[a0 + i];
  }
  for (int i = threadIdx.x; i < wb; i += MERGE_THREADS) {
    sb_hi[i] = b_hi[b0 + i];
    sb_lo[i] = b_lo[b0 + i];
  }
  __syncthreads();

  const int total = wa + wb;
  int di = threadIdx.x * MERGE_ITEMS;
  if (di > total) di = total;
  int ai = (int)kt_merge_path(
      [&](long long i) { return kt_word(sa_hi[i], sa_lo[i]); }, wa,
      [&](long long i) { return kt_word(sb_hi[i], sb_lo[i]); }, wb, di);
  int bi = di - ai;
  u32 r_hi[MERGE_ITEMS], r_lo[MERGE_ITEMS], r_w[MERGE_ITEMS];
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j) {
    if (di + j >= total) break;
    const bool take_a =
        bi >= wb || (ai < wa && kt_word(sa_hi[ai], sa_lo[ai]) <=
                                    kt_word(sb_hi[bi], sb_lo[bi]));
    if (take_a) {
      r_hi[j] = sa_hi[ai];
      r_lo[j] = sa_lo[ai];
      r_w[j] = sa_w[ai];
      ++ai;
    } else {
      r_hi[j] = sb_hi[bi];
      r_lo[j] = sb_lo[bi];
      r_w[j] = (sb_hi[bi] >> 31) ^ 1u;
      ++bi;
    }
  }
  __syncthreads();  // every thread is done reading the windows
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j) {
    if (di + j >= total) break;
    sa_hi[di + j] = r_hi[j];
    sa_lo[di + j] = r_lo[j];
    sa_w[di + j] = r_w[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += MERGE_THREADS) {
    o_hi[d0 + i] = sa_hi[i];
    o_lo[d0 + i] = sa_lo[i];
    o_w[d0 + i] = sa_w[i];
  }
}

__global__ void __launch_bounds__(COMPRESS_THREADS)
kt_compress_count_kernel(const uint8_t* __restrict__ keep, long long n,
                         long long* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * COMPRESS_THREADS + threadIdx.x;
  const int kept = __syncthreads_count(i < n && keep[i] != 0);
  if (threadIdx.x == 0) counts[blockIdx.x] = kept;
}

__global__ void __launch_bounds__(COMPRESS_THREADS)
kt_compress_kernel(const u32* __restrict__ hi, const u32* __restrict__ lo,
                   const u32* __restrict__ pay,
                   const uint8_t* __restrict__ keep,
                   const long long* __restrict__ offs, long long n,
                   u32* __restrict__ o_hi, u32* __restrict__ o_lo,
                   u32* __restrict__ o_pay) {
  __shared__ int warp_off[COMPRESS_THREADS / 32];
  const long long i = (long long)blockIdx.x * COMPRESS_THREADS + threadIdx.x;
  const bool kept = i < n && keep[i] != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const u32 ballot = __ballot_sync(0xFFFFFFFFu, kept);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the 32 warp totals by shuffles
    const int tot = warp_off[lane];
    int incl = tot;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, s);
      if (lane >= s) incl += up;
    }
    __syncwarp();
    warp_off[lane] = incl - tot;
  }
  __syncthreads();
  if (kept) {
    const long long dst = offs[blockIdx.x] + warp_off[warp] + rank;
    o_hi[dst] = hi[i];
    o_lo[dst] = lo[i];
    o_pay[dst] = pay[i];
  }
}

KT_EXPORT int kt_merge_tile() { return MERGE_TILE; }

KT_EXPORT int kt_compress_block() { return COMPRESS_THREADS; }

// part: scratch of ceil((nA + nB) / MERGE_TILE) + 1 int64 lanes.
KT_EXPORT int kt_merge_sorted(const void* a_hi, const void* a_lo,
                              const void* a_w, long long na, const void* b_hi,
                              const void* b_lo, long long nb, void* part,
                              void* o_hi, void* o_lo, void* o_w,
                              void* stream) {
  const long long n = na + nb;
  if (n == 0) return 0;
  const long long tiles = (n + MERGE_TILE - 1) / MERGE_TILE;
  const long long n_parts = tiles + 1;
  cudaStream_t st = (cudaStream_t)stream;
  kt_merge_partition_kernel<<<(unsigned)((n_parts + 255) / 256), 256, 0, st>>>(
      (const u32*)a_hi, (const u32*)a_lo, na, (const u32*)b_hi,
      (const u32*)b_lo, nb, (long long*)part, n_parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kt_merge_kernel<<<(unsigned)tiles, MERGE_THREADS, 0, st>>>(
      (const u32*)a_hi, (const u32*)a_lo, (const u32*)a_w, na,
      (const u32*)b_hi, (const u32*)b_lo, nb, (const long long*)part,
      (u32*)o_hi, (u32*)o_lo, (u32*)o_w);
  return (int)cudaGetLastError();
}

// counts: ceil(n / COMPRESS_THREADS) int64 lanes.
KT_EXPORT int kt_compress_block_counts(const void* keep, long long n,
                                       void* counts, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + COMPRESS_THREADS - 1) / COMPRESS_THREADS;
  kt_compress_count_kernel<<<(unsigned)blocks, COMPRESS_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)keep, n, (long long*)counts);
  return (int)cudaGetLastError();
}

// offs: exclusive cumsum of the block counts (int64).
KT_EXPORT int kt_compress_flagged(const void* hi, const void* lo,
                                  const void* pay, const void* keep,
                                  const void* offs, long long n, void* o_hi,
                                  void* o_lo, void* o_pay, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + COMPRESS_THREADS - 1) / COMPRESS_THREADS;
  kt_compress_kernel<<<(unsigned)blocks, COMPRESS_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const u32*)hi, (const u32*)lo, (const u32*)pay, (const uint8_t*)keep,
      (const long long*)offs, n, (u32*)o_hi, (u32*)o_lo, (u32*)o_pay);
  return (int)cudaGetLastError();
}
