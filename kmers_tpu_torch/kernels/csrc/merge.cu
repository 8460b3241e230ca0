// Consolidation kernels: the streaming merge of the count table with the
// sorted pending keys, the stable compaction of flagged lanes, and the
// reduction of the merged lanes' runs to a compact table.
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
// K4 13 B in and 12 B out a kept lane, against a handful of compares
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
// K3 WEIGHTED_B, a compile-time flag of the same template (NK = 2): B
// carries its own weight plane, and no lane of either side is dead, so
// the unsigned (hi, lo) order holds for every key, bit 63 included
// (k = 32 keys fill the word).  Consolidation merges key-sorted count
// tables with it (count.merge_sorted_tables), pairwise.  It replaces no
// TPU kernel: the JAX package's k = 32 path re-counts by weight
// (kmers_tpu/parallel/count.py:347-373).  Bound by bytes: 12 B in and 12
// B out a lane.  Shared memory holds six planes, so its tile is 1536
// lanes (36 KB).
//
// K4 compaction, one pass.  The TPU kernel carried a partial row between
// sequential grid steps and took its block offsets from a cumsum outside
// the kernel (merge.py:303-305).  Blocks here run in any order; a count
// pass and a cumsum for the offsets would read the keep plane twice, one
// byte a thread, and cost two more launches (with them K4 took twice its
// bound).  So one kernel, after one memset of its scratch, moves each
// byte once.  A block takes its CF_TILE-lane tile from an atomic ticket,
// so every predecessor of a tile is resident or done.  Each thread reads
// its 16 keep bytes as one 16-byte load (a lane is kept where its byte is
// nonzero, tested byte by byte with __vcmpne4) and the three planes as
// warp-contiguous 16-byte loads, issued before the scan so that they are
// in flight during it.  A shuffle scan ranks the kept lanes in the tile.
// The tile publishes its kept count as a 64-bit status word (flag and
// count in one store, read volatile, so no fence orders them), then warp
// 0 reads 32 predecessors' words at a time until it meets an inclusive
// prefix (Merrill and Garland's decoupled look-back, as sort.cu does for
// K11) and publishes its own.  The kept lanes are staged in shared memory
// at their tile rank and written by consecutive threads to consecutive
// addresses from the tile's global offset.  A ragged last tile, or a
// plane or keep pointer off 16 bytes (a view such as x[1:]), takes scalar
// loads instead.  At 2^25 lanes, half kept, it reaches about 70 % of the
// memory rate (PERF.md, section 6); 128-thread tiles beat 64-thread ones.
//
// K13 reduce_runs: the merged planes of K3 / K6 (NK key planes and the
// weight) to a compact table: each run of equal valid keys becomes its
// key and its weight sum mod 2^32, at its rank.  It replaces no TPU
// kernel: the JAX package's consolidation (kmers_tpu/parallel/count.py,
// merge_table_with_sorted_units) finds run starts, takes an exclusive
// cumsum of the weights and compacts both with K4, in jnp around the
// kernel, and the port did the same in PyTorch, with int64 temporaries
// over every merged lane.  Bound by bytes: it reads the 4 (NK + 1) bytes
// of a merged lane twice (once a pass) and writes 4 (NK + 1) bytes a
// table slot.  Two passes over the same tiles (2048 lanes at NK = 2, 1024
// at NK = 4, one tile a block in both):
//   tiles  counts the tile's run starts and its lead, the weight of its
//          lanes before its first start (all of them if it has none), and
//          takes the exclusive sum of the starts by K4's decoupled
//          look-back; the last tile writes the total, the table's
//          n_unique, which the host reads to size the outputs;
//   reduce stages the tile in shared memory, ranks its run starts and
//          takes the exclusive weight prefix of each lane by block scans,
//          and writes each run's key and the difference of consecutive
//          starts' prefixes; the tile's last run adds the leads of the
//          tiles after it up to the next one with a start (warp 0 reads 32
//          tiles' words at a time), so a run may cross any number of tiles.
// No lane-wide temporary but the outputs; the scratch is three 8-byte
// words a tile.  A lane is valid where bit 31 of plane 0 is clear (the
// folded flag; flagged lanes come last and weigh nothing); a valid lane
// starts a run where its key differs from the lane before it (lane 0:
// always; a tile's first lane reads its halo from global memory).
// ALL_VALID, a compile-time flag of both passes: every lane is valid and
// no bit is tested, for keys that fill the word (k = 32: the weighted
// K3's merges of live lanes).  It too replaces no TPU kernel (the JAX
// package's k = 32 re-count, kmers_tpu/parallel/count.py:347-373), and
// is bound by bytes alike: 12 B in (twice) and 12 B out a lane at NK = 2.

#include "common.cuh"

#define MERGE_THREADS 256
#define CF_THREADS 128
#define CF_ITEMS 16                        // lanes a thread: one keep load
#define CF_TILE (CF_THREADS * CF_ITEMS)    // 2048 lanes a block
#define CF_VECS (CF_ITEMS / 4)             // 16-byte loads a thread a plane
#define CF_AGGREGATE (1ull << 62)          // the tile's own kept count
#define CF_PREFIX (1ull << 63)             // kept lanes in tiles 0 .. this
#define CF_VALUE (CF_AGGREGATE - 1)
#define CF_FULL 0xFFFFFFFFu

// Lanes per thread of the NK-plane merge, WB: B carries its weight
// plane; tile = MERGE_THREADS * ITEMS.
template <int NK, bool WB = false> struct MergeItems;
template <> struct MergeItems<2> { static constexpr int value = 8; };
template <> struct MergeItems<4> { static constexpr int value = 4; };
template <> struct MergeItems<2, true> { static constexpr int value = 6; };

template <int NK, bool WB = false>
__host__ __device__ constexpr int kt_tile() {
  return MERGE_THREADS * MergeItems<NK, WB>::value;
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

template <int NK, bool WB>
__global__ void kt_merge_partition_kernel(InPlanes<NK> a, long long na,
                                          InPlanes<NK> b, long long nb,
                                          long long* part,
                                          long long n_parts) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_parts) return;
  const long long n = na + nb;
  long long d = t * kt_tile<NK, WB>();
  if (d > n) d = n;
  part[t] = kt_merge_path([&](long long i) { return kt_key<NK>(a.p, i); }, na,
                          [&](long long i) { return kt_key<NK>(b.p, i); }, nb,
                          d);
}

// a: NK key planes + the weight; b: NK key planes (WB: + the weight); o:
// NK planes + weight.  WITH_IDX also writes o_idx, the source-index plane
// of merge.py:402-405: an A lane's rank in A, or 0x80000000 | a B lane's
// rank in B.  It is staged in sb[0], free after the second barrier, so
// shared memory stays at 2 NK + 1 planes (a fourth plane in sa would
// reach the 48 KB limit).
template <int NK, bool WITH_IDX, bool WB>
__global__ void __launch_bounds__(MERGE_THREADS)
kt_merge_kernel(InPlanes<NK + 1> a, long long na, InPlanes<NK + WB> b,
                long long nb, const long long* __restrict__ part,
                OutPlanes<NK + 1> o, u32* __restrict__ o_idx) {
  constexpr int ITEMS = MergeItems<NK, WB>::value;
  constexpr int TILE = kt_tile<NK, WB>();
  __shared__ u32 sa[NK + 1][TILE];
  __shared__ u32 sb[NK + WB][TILE];
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
    for (int j = 0; j < NK + WB; ++j) sb[j][i] = b.p[j][b0 + i];
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
      if constexpr (WB) r[NK][it] = sb[NK][bi];
      else r[NK][it] = (sb[0][bi] >> 31) ^ 1u;
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
template <int NK, bool WITH_IDX, bool WB = false>
static int kt_merge_launch(InPlanes<NK + 1> a, long long na,
                           InPlanes<NK + WB> b, long long nb, long long* part,
                           OutPlanes<NK + 1> o, u32* o_idx, cudaStream_t st) {
  constexpr int TILE = kt_tile<NK, WB>();
  const long long n = na + nb;
  if (n == 0) return 0;
  const long long tiles = (n + TILE - 1) / TILE;
  const long long n_parts = tiles + 1;
  InPlanes<NK> ak, bk;
  for (int j = 0; j < NK; ++j) {
    ak.p[j] = a.p[j];
    bk.p[j] = b.p[j];
  }
  kt_merge_partition_kernel<NK, WB><<<(unsigned)((n_parts + 255) / 256), 256,
                                      0, st>>>(ak, na, bk, nb, part, n_parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kt_merge_kernel<NK, WITH_IDX, WB><<<(unsigned)tiles, MERGE_THREADS, 0, st>>>(
      a, na, b, nb, part, o, o_idx);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ u64 cf_load(const u64* p) {
  return *(const volatile u64*)p;
}

__device__ __forceinline__ void cf_store(u64* p, u64 v) {
  *(volatile u64*)p = v;
}

__device__ __forceinline__ bool cf_aligned(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Bit i set where byte i of w is nonzero (any value, not only 1).
__device__ __forceinline__ u32 cf_nonzero4(u32 w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Warp 0's decoupled look-back: publish the tile's count `total`, sum the
// counts of the tiles before it and publish the inclusive prefix.
// Returns the exclusive prefix (in every lane of warp 0).
__device__ __forceinline__ long long cf_look_back(u64* status,
                                                  long long tile,
                                                  u32 total) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) cf_store(status, CF_PREFIX | total);
    return 0;
  }
  if (lane == 0) cf_store(status + tile, CF_AGGREGATE | total);
  long long excl = 0;
  // lane l reads tile t - l; a window with a tile that has published
  // nothing yet is read again (every such tile is resident: the ticket)
  for (long long t = tile - 1;; t -= 32) {
    u64 s;
    do {
      s = t - lane >= 0 ? cf_load(status + t - lane) : CF_PREFIX;
    } while (__any_sync(CF_FULL, !(s & (CF_AGGREGATE | CF_PREFIX))));
    const u32 prefix = __ballot_sync(CF_FULL, (s & CF_PREFIX) != 0);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    u64 add = lane <= stop ? s & CF_VALUE : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) add += __shfl_xor_sync(CF_FULL, add, o);
    excl += (long long)add;
    if (prefix) break;
  }
  if (lane == 0) cf_store(status + tile, CF_PREFIX | (u64)(excl + total));
  return excl;
}

// K4: block = one CF_TILE-lane tile, taken from the ticket.  Thread t
// owns the keep bytes of lanes 16 t .. 16 t + 15 of the tile and loads
// the planes' lanes 4 q .. 4 q + 3 for q = j * CF_THREADS + t, so that
// every load instruction of a warp reads contiguous bytes.
__global__ void __launch_bounds__(CF_THREADS)
kt_compress_kernel(const u32* __restrict__ hi, const u32* __restrict__ lo,
                   const u32* __restrict__ pay,
                   const uint8_t* __restrict__ keep, long long n,
                   u32* __restrict__ o_hi, u32* __restrict__ o_lo,
                   u32* __restrict__ o_pay, u32* ticket, u64* status) {
  __shared__ u32 stage[3][CF_TILE];      // kept lanes at their tile rank
  __shared__ u32 s_mask[CF_THREADS];     // bit i: lane 16 t + i is kept
  __shared__ u32 s_off[CF_THREADS];      // kept lanes before lane 16 t
  __shared__ u32 warp_sum[CF_THREADS / 32];
  __shared__ long long s_tile, s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long t0 = tile * CF_TILE;
  const bool full = t0 + CF_TILE <= n;

  const u32* src[3] = {hi, lo, pay};
  u32 v[3][CF_ITEMS];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const bool vec = full && cf_aligned(src[p]);
#pragma unroll
    for (int j = 0; j < CF_VECS; ++j) {
      const long long i = t0 + 4 * (j * CF_THREADS + tid);
      if (vec) {
        const uint4 q = *reinterpret_cast<const uint4*>(src[p] + i);
        v[p][4 * j] = q.x;
        v[p][4 * j + 1] = q.y;
        v[p][4 * j + 2] = q.z;
        v[p][4 * j + 3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[p][4 * j + e] = i + e < n ? src[p][i + e] : 0u;
      }
    }
  }
  u32 m = 0;
  const long long k0 = t0 + CF_ITEMS * tid;
  if (full && cf_aligned(keep)) {
    const uint4 q = *reinterpret_cast<const uint4*>(keep + k0);
    m = cf_nonzero4(q.x) | cf_nonzero4(q.y) << 4 | cf_nonzero4(q.z) << 8 |
        cf_nonzero4(q.w) << 12;
  } else {
    for (int i = 0; i < CF_ITEMS && k0 + i < n; ++i)
      if (keep[k0 + i]) m |= 1u << i;
  }

  // exclusive scan of the threads' kept counts, in thread order
  const u32 cnt = __popc(m);
  u32 x = cnt;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const u32 up = __shfl_up_sync(CF_FULL, x, s);
    if (lane >= s) x += up;
  }
  if (lane == 31) warp_sum[warp] = x;
  s_mask[tid] = m;
  __syncthreads();
  u32 before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < CF_THREADS / 32; ++w) {
    before += w < warp ? warp_sum[w] : 0u;
    total += warp_sum[w];
  }
  s_off[tid] = before + x - cnt;
  if (warp == 0) {
    const long long excl = cf_look_back(status, tile, total);
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < CF_VECS; ++j) {
    const int q = j * CF_THREADS + tid;
    const u32 owner = s_mask[q >> 2];
    const int sh = 4 * (q & 3);
    u32 r = s_off[q >> 2] + __popc(owner & ((1u << sh) - 1u));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((owner >> (sh + e)) & 1u) {
        stage[0][r] = v[0][4 * j + e];
        stage[1][r] = v[1][4 * j + e];
        stage[2][r] = v[2][4 * j + e];
        ++r;
      }
    }
  }
  __syncthreads();
  const long long excl = s_excl;
  for (int i = tid; i < (int)total; i += CF_THREADS) {
    o_hi[excl + i] = stage[0][i];
    o_lo[excl + i] = stage[1][i];
    o_pay[excl + i] = stage[2][i];
  }
}

#define RR_THREADS 256
#define RR_WARPS (RR_THREADS / 32)

// Lanes per thread of K13 over NK key planes; tile = RR_THREADS * ITEMS.
template <int NK> struct RunItems;
template <> struct RunItems<2> { static constexpr int value = 8; };
template <> struct RunItems<4> { static constexpr int value = 4; };

template <int NK>
__host__ __device__ constexpr int rr_tile() {
  return RR_THREADS * RunItems<NK>::value;
}

template <int NK>
static long long rr_tiles(long long n) {
  return (n + rr_tile<NK>() - 1) / rr_tile<NK>();
}

// A staged lane's place in shared memory: one pad word every 32 lanes,
// so that a thread's run of ITEMS lanes (8 or 4 words apart from the next
// thread's) meets no bank conflict.
__device__ __forceinline__ int rr_pad(int i) { return i + (i >> 5); }

// K13's scratch of `tiles` tiles, 3 tiles + 2 words of 8 bytes: the
// ticket, a look-back status word a tile, a (run starts, lead) pair a
// tile, then the tiles' exclusive start offsets and, last, their total.
struct RunScratch {
  u32* ticket;
  u64* status;
  uint2* info;
  long long* off;
};

static RunScratch rr_scratch(void* base, long long tiles) {
  u64* w = (u64*)base;
  return {(u32*)w, w + 1, (uint2*)(w + 1 + tiles),
          (long long*)(w + 1 + 2 * tiles)};
}

// K13, first pass: block = one tile, taken from the ticket.  Thread t
// reads lanes it * RR_THREADS + t (coalesced; lane i - 1 of the start
// test comes from the line its neighbour just loaded).
template <int NK, bool ALL_VALID>
__global__ void __launch_bounds__(RR_THREADS)
kt_run_tiles_kernel(InPlanes<NK + 1> m, long long n, long long tiles,
                    RunScratch sc) {
  constexpr int ITEMS = RunItems<NK>::value;
  constexpr int TILE = rr_tile<NK>();
  __shared__ u32 s_cnt[RR_WARPS], s_first[RR_WARPS], s_lead[RR_WARPS];
  __shared__ long long s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(sc.ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long t0 = tile * TILE;
  u32 w[ITEMS];
  u32 cnt = 0, first = TILE;     // starts; the first start's lane
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int l = it * RR_THREADS + tid;
    const long long i = t0 + l;
    w[it] = 0;
    if (i < n && (ALL_VALID || !(m.p[0][i] >> 31))) {
      w[it] = m.p[NK][i];
      bool differs = i == 0;
#pragma unroll
      for (int j = 0; j < NK; ++j)
        differs |= i > 0 && m.p[j][i] != m.p[j][i - 1];
      if (differs) {
        ++cnt;
        first = min(first, (u32)l);
      }
    }
  }
  cnt = __reduce_add_sync(CF_FULL, cnt);
  first = __reduce_min_sync(CF_FULL, first);
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_first[warp] = first;
  }
  __syncthreads();
  u32 total = 0;
  first = TILE;
#pragma unroll
  for (int k = 0; k < RR_WARPS; ++k) {
    total += s_cnt[k];
    first = min(first, s_first[k]);
  }
  u32 lead = 0;                  // the weight before the first start
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
    if ((u32)(it * RR_THREADS + tid) < first) lead += w[it];
  lead = __reduce_add_sync(CF_FULL, lead);
  if (lane == 0) s_lead[warp] = lead;
  __syncthreads();
  if (warp == 0) {
    const long long excl = cf_look_back(sc.status, tile, total);
    if (lane == 0) {
      u32 lead_all = 0;
#pragma unroll
      for (int k = 0; k < RR_WARPS; ++k) lead_all += s_lead[k];
      sc.info[tile] = make_uint2(total, lead_all);
      sc.off[tile] = excl;
      if (tile == tiles - 1) sc.off[tiles] = excl + total;
    }
  }
}

// K13, second pass: block = tile blockIdx.x.  Thread t owns lanes
// ITEMS t .. ITEMS t + ITEMS - 1 of the staged tile, so that the block
// scans run in lane order.
template <int NK, bool ALL_VALID>
__global__ void __launch_bounds__(RR_THREADS)
kt_reduce_runs_kernel(InPlanes<NK + 1> m, long long n, long long tiles,
                      RunScratch sc, OutPlanes<NK + 1> o) {
  constexpr int ITEMS = RunItems<NK>::value;
  constexpr int TILE = rr_tile<NK>();
  __shared__ u32 s[NK + 1][TILE + TILE / 32];
  __shared__ unsigned short s_lane[TILE];   // the lane of the r-th start
  __shared__ u32 s_halo[NK];                // the key of lane t0 - 1
  __shared__ u32 s_cnt[RR_WARPS], s_sum[RR_WARPS];
  __shared__ u32 s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile = blockIdx.x;
  const long long t0 = tile * TILE;
  const int width = (int)(n - t0 < TILE ? n - t0 : TILE);
  for (int i = tid; i < width; i += RR_THREADS) {
#pragma unroll
    for (int j = 0; j <= NK; ++j) s[j][rr_pad(i)] = m.p[j][t0 + i];
  }
  if (tid < NK) s_halo[tid] = t0 > 0 ? m.p[tid][t0 - 1] : 0u;
  if (warp == 0) {
    // the weight past the tile that belongs to its last run: the leads
    // of the tiles after it, through the first one with a start
    u32 carry = 0;
    for (long long u0 = tile + 1; u0 < tiles; u0 += 32) {
      const long long u = u0 + lane;
      const uint2 f = u < tiles ? sc.info[u] : make_uint2(1u, 0u);
      const u32 stop = __ballot_sync(CF_FULL, f.x != 0);
      const int last = stop ? __ffs(stop) - 1 : 31;
      carry += __reduce_add_sync(CF_FULL, lane <= last ? f.y : 0u);
      if (stop) break;
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();

  const int b = tid * ITEMS;
  u32 prev[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j)
    prev[j] = b == 0 ? s_halo[j] : s[j][rr_pad(b - 1)];
  u32 mask = 0, cnt = 0, sum = 0, pre[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = b + it;
    u32 wt = 0;
    if (i < width) {
      bool differs = t0 + i == 0;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const u32 key = s[j][rr_pad(i)];
        differs |= key != prev[j];
        prev[j] = key;
      }
      if (ALL_VALID || !(prev[0] >> 31)) {
        wt = s[NK][rr_pad(i)];
        if (differs) {
          mask |= 1u << it;
          ++cnt;
        }
      }
    }
    pre[it] = sum;
    sum += wt;
  }
  // exclusive scans of the threads' starts and weights, in lane order
  u32 xc = cnt, xs = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u32 uc = __shfl_up_sync(CF_FULL, xc, d);
    const u32 us = __shfl_up_sync(CF_FULL, xs, d);
    if (lane >= d) {
      xc += uc;
      xs += us;
    }
  }
  if (lane == 31) {
    s_cnt[warp] = xc;
    s_sum[warp] = xs;
  }
  __syncthreads();
  u32 rank = xc - cnt, base = xs - sum, total = 0, tile_sum = 0;
#pragma unroll
  for (int k = 0; k < RR_WARPS; ++k) {
    if (k < warp) {
      rank += s_cnt[k];
      base += s_sum[k];
    }
    total += s_cnt[k];
    tile_sum += s_sum[k];
  }
  // the weight plane becomes each lane's exclusive weight prefix in the
  // tile: no thread reads another thread's weights
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = b + it;
    if (i < width) {
      s[NK][rr_pad(i)] = base + pre[it];
      if ((mask >> it) & 1u) s_lane[rank++] = (unsigned short)i;
    }
  }
  __syncthreads();
  const long long off = sc.off[tile];
  const u32 end_sum = tile_sum + s_carry;
  for (int r = tid; r < (int)total; r += RR_THREADS) {
    const int i = rr_pad(s_lane[r]);
#pragma unroll
    for (int j = 0; j < NK; ++j) o.p[j][off + r] = s[j][i];
    const u32 end =
        r + 1 < (int)total ? s[NK][rr_pad(s_lane[r + 1])] : end_sum;
    o.p[NK][off + r] = end - s[NK][i];
  }
}

template <int NK>
static int kt_run_tiles_launch(bool all_valid, InPlanes<NK + 1> m,
                               long long n, void* scratch, cudaStream_t st) {
  const long long tiles = rr_tiles<NK>(n);
  cudaError_t err = cudaMemsetAsync(scratch, 0,
                                    (size_t)(3 * tiles + 2) * sizeof(u64), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  const RunScratch sc = rr_scratch(scratch, tiles);
  if (all_valid)
    kt_run_tiles_kernel<NK, true><<<(unsigned)tiles, RR_THREADS, 0, st>>>(
        m, n, tiles, sc);
  else
    kt_run_tiles_kernel<NK, false><<<(unsigned)tiles, RR_THREADS, 0, st>>>(
        m, n, tiles, sc);
  return (int)cudaGetLastError();
}

template <int NK>
static int kt_reduce_runs_launch(bool all_valid, InPlanes<NK + 1> m,
                                 long long n, void* scratch,
                                 long long n_unique, long long out_lanes,
                                 OutPlanes<NK + 1> o, cudaStream_t st) {
  if (n_unique < 0 || n_unique > n || out_lanes < n_unique)
    return (int)cudaErrorInvalidValue;
  const long long tiles = rr_tiles<NK>(n);
  if (n_unique > 0) {
    const RunScratch sc = rr_scratch(scratch, tiles);
    if (all_valid)
      kt_reduce_runs_kernel<NK, true><<<(unsigned)tiles, RR_THREADS, 0, st>>>(
          m, n, tiles, sc, o);
    else
      kt_reduce_runs_kernel<NK, false><<<(unsigned)tiles, RR_THREADS, 0,
                                         st>>>(m, n, tiles, sc, o);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int j = 0; j <= NK && out_lanes > n_unique; ++j) {
    cudaError_t err = cudaMemsetAsync(
        o.p[j] + n_unique, 0, (size_t)(out_lanes - n_unique) * sizeof(u32),
        st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

static long long kt_compress_tiles(long long n) {
  return (n + CF_TILE - 1) / CF_TILE;
}

KT_EXPORT int kt_merge_tile() { return kt_tile<2>(); }

KT_EXPORT int kt_merge_tile_wide() { return kt_tile<4>(); }

KT_EXPORT int kt_merge_tile_weighted() { return kt_tile<2, true>(); }

// int64 lanes of kt_compress_flagged's scratch for n lanes: the ticket,
// then one status word a tile.
KT_EXPORT long long kt_compress_scratch_lanes(long long n) {
  return kt_compress_tiles(n) + 1;
}

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

// K3 WEIGHTED_B: B's weight plane b_w; no dead lane on either side; part:
// ceil((nA + nB) / kt_merge_tile_weighted()) + 1 int64 lanes.
KT_EXPORT int kt_merge_sorted_weighted(const void* a_hi, const void* a_lo,
                                       const void* a_w, long long na,
                                       const void* b_hi, const void* b_lo,
                                       const void* b_w, long long nb,
                                       void* part, void* o_hi, void* o_lo,
                                       void* o_w, void* stream) {
  InPlanes<3> a = {{(const u32*)a_hi, (const u32*)a_lo, (const u32*)a_w}};
  InPlanes<3> b = {{(const u32*)b_hi, (const u32*)b_lo, (const u32*)b_w}};
  OutPlanes<3> o = {{(u32*)o_hi, (u32*)o_lo, (u32*)o_w}};
  return kt_merge_launch<2, false, true>(a, na, b, nb, (long long*)part, o,
                                         nullptr, (cudaStream_t)stream);
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

// K4; scratch: kt_compress_scratch_lanes(n) int64 lanes, zeroed here on
// the stream (the call's one memset).  Any pointer alignment.
KT_EXPORT int kt_compress_flagged(const void* hi, const void* lo,
                                  const void* pay, const void* keep,
                                  long long n, void* scratch, void* o_hi,
                                  void* o_lo, void* o_pay, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = kt_compress_tiles(n);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)kt_compress_scratch_lanes(n) * sizeof(u64), st);
  if (err != cudaSuccess) return (int)err;
  u64* words = (u64*)scratch;
  kt_compress_kernel<<<(unsigned)tiles, CF_THREADS, 0, st>>>(
      (const u32*)hi, (const u32*)lo, (const u32*)pay, (const uint8_t*)keep,
      n, (u32*)o_hi, (u32*)o_lo, (u32*)o_pay, (u32*)words, words + 1);
  return (int)cudaGetLastError();
}

// 8-byte words of K13's scratch for n merged lanes over nk = 2 or 4 key
// planes; the last one receives n_unique.
KT_EXPORT long long kt_reduce_scratch_lanes(long long n, int nk) {
  return 3 * (nk == 2 ? rr_tiles<2>(n) : rr_tiles<4>(n)) + 2;
}

// K13, first pass over n merged lanes: planes p0 .. p(nk-1) the keys,
// most significant first, p(nk) the weights (the pointers past it are
// unused); all_valid: ALL_VALID's instantiation (no flag bit); scratch:
// kt_reduce_scratch_lanes(n, nk) words, zeroed here on the stream (the
// pass's one memset).  Its last word then holds n_unique.
KT_EXPORT int kt_reduce_runs_tiles(int nk, int all_valid, const void* p0,
                                   const void* p1, const void* p2,
                                   const void* p3, const void* p4,
                                   long long n, void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nk == 2) {
    InPlanes<3> m = {{(const u32*)p0, (const u32*)p1, (const u32*)p2}};
    return kt_run_tiles_launch<2>(all_valid, m, n, scratch, st);
  }
  if (nk == 4) {
    InPlanes<5> m = {{(const u32*)p0, (const u32*)p1, (const u32*)p2,
                      (const u32*)p3, (const u32*)p4}};
    return kt_run_tiles_launch<4>(all_valid, m, n, scratch, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K13, second pass: the same planes, flag and scratch, n_unique read from
// it; o0 .. o(nk) receive the keys and the counts, out_lanes >= n_unique
// lanes each, zero past n_unique.
KT_EXPORT int kt_reduce_runs(int nk, int all_valid, const void* p0,
                             const void* p1, const void* p2, const void* p3,
                             const void* p4, long long n, void* scratch,
                             long long n_unique, long long out_lanes,
                             void* o0, void* o1, void* o2, void* o3, void* o4,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nk == 2) {
    InPlanes<3> m = {{(const u32*)p0, (const u32*)p1, (const u32*)p2}};
    OutPlanes<3> o = {{(u32*)o0, (u32*)o1, (u32*)o2}};
    return kt_reduce_runs_launch<2>(all_valid, m, n, scratch, n_unique,
                                    out_lanes, o, st);
  }
  if (nk == 4) {
    InPlanes<5> m = {{(const u32*)p0, (const u32*)p1, (const u32*)p2,
                      (const u32*)p3, (const u32*)p4}};
    OutPlanes<5> o = {{(u32*)o0, (u32*)o1, (u32*)o2, (u32*)o3, (u32*)o4}};
    return kt_reduce_runs_launch<4>(all_valid, m, n, scratch, n_unique,
                                    out_lanes, o, st);
  }
  return (int)cudaErrorInvalidValue;
}
