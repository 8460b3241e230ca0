// Consolidation kernels: the streaming merge of the count table with the
// sorted pending keys, and the stable compaction of run starts.
//
// Replaces three Pallas functions of kmers_tpu/kernels/merge.py:
//   K3 merge_sorted       (_merge_sorted_impl at nk=2, _merge_kernel_n,
//                          _merge_path_search_n, _bitonic_merge_n), with
//                          and without with_idx's source-index plane
//   K6 merge_sorted_wide  (the same at nk=4: 128-bit keys)
//   K4 compress_flagged   (_compress_kernel)
//
// All are bound by device-memory bytes: K3 moves 20 B in and 12 B out
// per output lane (16 B out with the index plane; K6 36 B and 20 B) and
// K4 some 13 B in and up to 12 B out, against a handful of compares
// each.  The design moves each byte once, in coalesced lines:
//
// K3/K6 merge path (Green et al.), one template on the key plane count
// NK.  A small kernel splits the output into tile-lane ranges by binary
// search on the diagonals; a block then loads its A and B windows
// (together exactly its output range) into shared memory with coalesced
// reads, each thread finds its own sub-range of ITEMS lanes by a second
// search in shared memory and merges it sequentially, and the block
// writes its tile back through shared memory, again coalesced.  Shared
// memory holds 2 NK + 1 planes of a tile: 2048 lanes (40 KB) for NK = 2,
// 1024 lanes (36 KB) for NK = 4, both under the 48 KB static limit.  The
// TPU kernel sorted a 2*tile bitonic window per grid step because Mosaic
// has no data-dependent indexing; here each thread simply walks both
// windows.  Order: unsigned over the planes, most significant first, A
// before B on equal keys.  B weight = (plane 0 >> 31) ^ 1.  The output
// is exactly nA + nB lanes long (no pad lanes).
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
#define COMPRESS_THREADS 1024

// Lanes per thread of the NK-plane merge; tile = MERGE_THREADS * ITEMS.
template <int NK> struct MergeItems;
template <> struct MergeItems<2> { static constexpr int value = 8; };
template <> struct MergeItems<4> { static constexpr int value = 4; };

template <int NK>
__host__ __device__ constexpr int kt_tile() {
  return MERGE_THREADS * MergeItems<NK>::value;
}

// A key of NK uint32 planes as NK/2 64-bit words, most significant first.
template <int NK> struct Key { u64 w[NK / 2]; };

template <int NK>
__device__ __forceinline__ bool operator<=(const Key<NK>& a,
                                           const Key<NK>& b) {
#pragma unroll
  for (int j = 0; j + 1 < NK / 2; ++j)
    if (a.w[j] != b.w[j]) return a.w[j] < b.w[j];
  return a.w[NK / 2 - 1] <= b.w[NK / 2 - 1];
}

template <int N> struct InPlanes { const u32* p[N]; };
template <int N> struct OutPlanes { u32* p[N]; };

// The key of lane i of NK planes (global or shared memory alike).
template <int NK, typename Planes>
__device__ __forceinline__ Key<NK> kt_key(const Planes& s, long long i) {
  Key<NK> key;
#pragma unroll
  for (int j = 0; j < NK / 2; ++j)
    key.w[j] = kt_word(s[2 * j][i], s[2 * j + 1][i]);
  return key;
}

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

template <int NK>
__global__ void kt_merge_partition_kernel(InPlanes<NK> a, long long na,
                                          InPlanes<NK> b, long long nb,
                                          long long* part,
                                          long long n_parts) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_parts) return;
  const long long n = na + nb;
  long long d = t * kt_tile<NK>();
  if (d > n) d = n;
  part[t] = kt_merge_path([&](long long i) { return kt_key<NK>(a.p, i); }, na,
                          [&](long long i) { return kt_key<NK>(b.p, i); }, nb,
                          d);
}

// a: NK key planes + the weight; b: NK key planes; o: NK planes + weight.
// WITH_IDX also writes o_idx, the source-index plane of merge.py:402-405:
// an A lane's rank in A, or 0x80000000 | a B lane's rank in B.  It is
// staged in sb[0], free after the second barrier, so shared memory stays
// at 2 NK + 1 planes (a fourth plane in sa would reach the 48 KB limit).
template <int NK, bool WITH_IDX>
__global__ void __launch_bounds__(MERGE_THREADS)
kt_merge_kernel(InPlanes<NK + 1> a, long long na, InPlanes<NK> b,
                long long nb, const long long* __restrict__ part,
                OutPlanes<NK + 1> o, u32* __restrict__ o_idx) {
  constexpr int ITEMS = MergeItems<NK>::value;
  constexpr int TILE = kt_tile<NK>();
  __shared__ u32 sa[NK + 1][TILE];
  __shared__ u32 sb[NK][TILE];
  const long long n = na + nb;
  const long long d0 = (long long)blockIdx.x * TILE;
  const long long d1 = d0 + TILE < n ? d0 + TILE : n;
  const long long a0 = part[blockIdx.x], a1 = part[blockIdx.x + 1];
  const long long b0 = d0 - a0;
  const int wa = (int)(a1 - a0), wb = (int)((d1 - a1) - b0);
  for (int i = threadIdx.x; i < wa; i += MERGE_THREADS) {
#pragma unroll
    for (int j = 0; j <= NK; ++j) sa[j][i] = a.p[j][a0 + i];
  }
  for (int i = threadIdx.x; i < wb; i += MERGE_THREADS) {
#pragma unroll
    for (int j = 0; j < NK; ++j) sb[j][i] = b.p[j][b0 + i];
  }
  __syncthreads();

  const int total = wa + wb;
  int di = threadIdx.x * ITEMS;
  if (di > total) di = total;
  int ai = (int)kt_merge_path([&](long long i) { return kt_key<NK>(sa, i); },
                              wa,
                              [&](long long i) { return kt_key<NK>(sb, i); },
                              wb, di);
  int bi = di - ai;
  u32 r[NK + 1][ITEMS];
  u32 r_idx[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (di + it >= total) break;
    const bool take_a =
        bi >= wb || (ai < wa && kt_key<NK>(sa, ai) <= kt_key<NK>(sb, bi));
    if (take_a) {
#pragma unroll
      for (int j = 0; j <= NK; ++j) r[j][it] = sa[j][ai];
      if (WITH_IDX) r_idx[it] = (u32)(a0 + ai);
      ++ai;
    } else {
#pragma unroll
      for (int j = 0; j < NK; ++j) r[j][it] = sb[j][bi];
      r[NK][it] = (sb[0][bi] >> 31) ^ 1u;
      if (WITH_IDX) r_idx[it] = 0x80000000u | (u32)(b0 + bi);
      ++bi;
    }
  }
  __syncthreads();  // every thread is done reading the windows
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (di + it >= total) break;
#pragma unroll
    for (int j = 0; j <= NK; ++j) sa[j][di + it] = r[j][it];
    if (WITH_IDX) sb[0][di + it] = r_idx[it];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += MERGE_THREADS) {
#pragma unroll
    for (int j = 0; j <= NK; ++j) o.p[j][d0 + i] = sa[j][i];
    if (WITH_IDX) o_idx[d0 + i] = sb[0][i];
  }
}

// part: scratch of ceil((nA + nB) / tile) + 1 int64 lanes; o_idx: the
// source-index plane when WITH_IDX, else unused.
template <int NK, bool WITH_IDX>
static int kt_merge_launch(InPlanes<NK + 1> a, long long na, InPlanes<NK> b,
                           long long nb, long long* part, OutPlanes<NK + 1> o,
                           u32* o_idx, cudaStream_t st) {
  const long long n = na + nb;
  if (n == 0) return 0;
  const long long tiles = (n + kt_tile<NK>() - 1) / kt_tile<NK>();
  const long long n_parts = tiles + 1;
  InPlanes<NK> ak;
  for (int j = 0; j < NK; ++j) ak.p[j] = a.p[j];
  kt_merge_partition_kernel<NK><<<(unsigned)((n_parts + 255) / 256), 256, 0,
                                  st>>>(ak, na, b, nb, part, n_parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kt_merge_kernel<NK, WITH_IDX><<<(unsigned)tiles, MERGE_THREADS, 0, st>>>(
      a, na, b, nb, part, o, o_idx);
  return (int)cudaGetLastError();
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

KT_EXPORT int kt_merge_tile() { return kt_tile<2>(); }

KT_EXPORT int kt_merge_tile_wide() { return kt_tile<4>(); }

KT_EXPORT int kt_compress_block() { return COMPRESS_THREADS; }

// K3; part: ceil((nA + nB) / kt_merge_tile()) + 1 int64 lanes.
KT_EXPORT int kt_merge_sorted(const void* a_hi, const void* a_lo,
                              const void* a_w, long long na, const void* b_hi,
                              const void* b_lo, long long nb, void* part,
                              void* o_hi, void* o_lo, void* o_w,
                              void* stream) {
  InPlanes<3> a = {{(const u32*)a_hi, (const u32*)a_lo, (const u32*)a_w}};
  InPlanes<2> b = {{(const u32*)b_hi, (const u32*)b_lo}};
  OutPlanes<3> o = {{(u32*)o_hi, (u32*)o_lo, (u32*)o_w}};
  return kt_merge_launch<2, false>(a, na, b, nb, (long long*)part, o, nullptr,
                                   (cudaStream_t)stream);
}

// K3 with_idx (merge.py:138-140): kt_merge_sorted plus the source-index
// plane o_idx; nA and nB below 2^31.
KT_EXPORT int kt_merge_sorted_idx(const void* a_hi, const void* a_lo,
                                  const void* a_w, long long na,
                                  const void* b_hi, const void* b_lo,
                                  long long nb, void* part, void* o_hi,
                                  void* o_lo, void* o_w, void* o_idx,
                                  void* stream) {
  InPlanes<3> a = {{(const u32*)a_hi, (const u32*)a_lo, (const u32*)a_w}};
  InPlanes<2> b = {{(const u32*)b_hi, (const u32*)b_lo}};
  OutPlanes<3> o = {{(u32*)o_hi, (u32*)o_lo, (u32*)o_w}};
  return kt_merge_launch<2, true>(a, na, b, nb, (long long*)part, o,
                                  (u32*)o_idx, (cudaStream_t)stream);
}

// K6: key planes most significant first; part: ceil((nA + nB) /
// kt_merge_tile_wide()) + 1 int64 lanes.
KT_EXPORT int kt_merge_sorted_wide(const void* a3, const void* a2,
                                   const void* a1, const void* a0,
                                   const void* a_w, long long na,
                                   const void* b3, const void* b2,
                                   const void* b1, const void* b0,
                                   long long nb, void* part, void* o3,
                                   void* o2, void* o1, void* o0, void* o_w,
                                   void* stream) {
  InPlanes<5> a = {{(const u32*)a3, (const u32*)a2, (const u32*)a1,
                    (const u32*)a0, (const u32*)a_w}};
  InPlanes<4> b = {{(const u32*)b3, (const u32*)b2, (const u32*)b1,
                    (const u32*)b0}};
  OutPlanes<5> o = {{(u32*)o3, (u32*)o2, (u32*)o1, (u32*)o0, (u32*)o_w}};
  return kt_merge_launch<4, false>(a, na, b, nb, (long long*)part, o, nullptr,
                                   (cudaStream_t)stream);
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
