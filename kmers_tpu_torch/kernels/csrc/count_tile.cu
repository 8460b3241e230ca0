// K10: segment-local sort and run-length count of folded k-mer keys.
//
// Replaces kmers_tpu/kernels/count_tile.py: segment_count_keys (2 key
// planes, k <= 31) and segment_count_keys_wide (4 planes, 33 <= k <= 63),
// both _segment_count -> _count_tile_kernel.  Keys are NP uint32 planes,
// plane 0 most significant, with the invalid flag folded into bit 31 of
// plane 0 (an invalid lane is exactly (0x80000000, 0[, 0, 0])).  For each
// S-lane segment (S = seg_lanes, any power of two from 8 up that divides
// n_pad) of the n_pad output lanes (n_pad = n rounded up to block_lanes;
// lanes past n are invalid): the segment's keys ascending, valid first;
// counts = the run length at each run start and 0 elsewhere; invalid lanes
// all zero (keys & valid mask, so the flag is cleared too).  Run
// boundaries are the run starts and the first invalid lane
// (count_tile.py:171-191).
//
// Bound: device-memory bytes, 4 NP bytes in and 4 (NP + 1) out a lane (20
// B narrow, 36 B wide), against log2(S) (log2(S) + 1) / 4 compare-exchanges
// a lane (10.5 at S = 64).  The TPU kernel sorted many segments at once in
// one [rows, 128] block with rolls and selects, because Mosaic pays per
// vector op.
//
// The first port (one warp a segment, S / 32 keys a thread in striped
// order) spent its time in a dependent chain: 20 of its 21 bitonic stages
// at S = 64 crossed lanes, each a __shfl_xor_sync per 32-bit half, a
// compare and a select, with only two keys a thread to hide the shuffle
// latency; it took only S in 32 .. 256.
//
// Segments of up to SC_MAX_SEG = 4096 lanes, one kernel, one block a
// tile: blocked order, SC_ITEMS = 8 keys a thread, elements e = 8 t ..
// 8 t + 7 of its segment, loaded with 16-byte vector loads.  The
// network is the bitonic sorter in its all-ascending form: merge level kk
// first compares e with e ^ (kk - 1) (the "flip"), then e with e ^ s for
// s = kk / 4 .. 1, the smaller key always to the lower element.  A stage
// with stride below 8 is a compare-exchange between two registers of one
// thread; a stage with stride 8 .. 255 exchanges whole registers with the
// partner lane (__shfl_xor_sync, 8 independent keys a stage, each lane of
// the pair keeping the min or the max); at S = 64 that is 6 lane-crossing
// stages of 21 instead of 20.  Segments of more than 256 lanes span the
// warps of one block (up to 512 threads), and their strides of 256 and
// more exchange through shared memory between two barriers.  128-bit keys
// compare as unsigned __int128, one chain of extended compares.  Run
// starts compare each key with its predecessor (in the thread, or the
// previous lane's last key by __shfl_up_sync, or the previous warp's
// through shared memory); each start finds the next boundary in its
// thread's 8-bit boundary mask, else in the first later lane of the
// segment that has one (a ballot, __ffs and one __shfl_sync), else in the
// first later warp's (shared memory).  Each output plane goes through the
// warp's staging area in shared memory, so that every 16-byte store of a
// warp covers 512 contiguous bytes.  The 21 stages' compares and selects,
// not the bytes, still set the time (PERF.md).
//
// Larger segments do not fit one block (a wide 16384-lane segment is 256
// KB of keys), so they take 2 + log2(S / 4096) launches through global
// memory, NP planes of scratch beside the outputs:
//   1. the same kernel sorts each 4096-lane tile (SC_SORT_ONLY: keys with
//      their flag, so invalid lanes sort last, and no counts);
//   2. merge rounds double the sorted runs, 4096 lanes to S / 2 a run,
//      each pair inside one segment; a block takes 2048 output lanes,
//      finds its split by a merge-path search (as merge.cu's K3) and merges
//      its windows in shared memory, keys compared unsigned over the
//      planes (equal keys are identical, so no stability is needed);
//   3. the same kernel counts each 4096-lane chunk of the sorted segment
//      (SC_COUNT_ONLY: no network; a chunk's first lane compares with the
//      lane before it unless the segment starts there).  A run start with
//      no later boundary in its chunk (at most one a chunk) finds its
//      run's end by a binary search for the first larger key in the rest
//      of the segment: invalid keys, flag set, are larger than any valid.
// The passes alternate between the scratch and the output planes, so
// that the last merge round ends in the scratch.  This path is simple
// first; its times are in PERF.md.

#include "common.cuh"

#define SC_ITEMS 8                   // keys a thread, consecutive lanes
#define SC_MAX_SEG 4096              // the largest segment (512 threads)
#define SC_FULL 0xFFFFFFFFu
#define MR_THREADS 256               // a merge round's block
#define MR_TILE (MR_THREADS * SC_ITEMS)  // its 2048 output lanes

// What one launch of the segment kernel does: sort and count segments of
// up to SC_MAX_SEG lanes, or pass 1 or 3 of the large-segment path.
enum ScMode { SC_SORT_COUNT = 0, SC_SORT_ONLY = 1, SC_COUNT_ONLY = 2 };

template <int N> struct SCIn { const u32* p[N]; };
template <int N> struct SCOut { u32* p[N]; };

// NP planes as NP / 2 64-bit words, most significant first.
template <int NP> struct SKey { u64 w[NP / 2]; };

// one chain of extended compares for 128-bit keys
template <int NP>
__device__ __forceinline__ bool skey_lt(const SKey<NP>& a, const SKey<NP>& b) {
  if constexpr (NP == 2) {
    return a.w[0] < b.w[0];
  } else {
    typedef unsigned __int128 u128;
    return ((u128)a.w[0] << 64 | a.w[1]) < ((u128)b.w[0] << 64 | b.w[1]);
  }
}

template <int NP>
__device__ __forceinline__ bool skey_eq(const SKey<NP>& a, const SKey<NP>& b) {
  bool eq = true;
#pragma unroll
  for (int q = 0; q < NP / 2; ++q) eq = eq && a.w[q] == b.w[q];
  return eq;
}

// a, b = min(a, b), max(a, b)
template <int NP>
__device__ __forceinline__ void skey_cmpx(SKey<NP>& a, SKey<NP>& b) {
  const bool swap = skey_lt<NP>(b, a);
#pragma unroll
  for (int q = 0; q < NP / 2; ++q) {
    const u64 x = a.w[q], y = b.w[q];
    a.w[q] = swap ? y : x;
    b.w[q] = swap ? x : y;
  }
}

// min(a, p) when low, else max(a, p); equal keys are interchangeable
template <int NP>
__device__ __forceinline__ void skey_keep(SKey<NP>& a, const SKey<NP>& p,
                                          bool low) {
  const bool take = skey_lt<NP>(p, a) == low;
#pragma unroll
  for (int q = 0; q < NP / 2; ++q) a.w[q] = take ? p.w[q] : a.w[q];
}

// the key of lane i of NP uint32 planes (global or shared memory)
template <int NP, typename Planes>
__device__ __forceinline__ SKey<NP> skey_at(const Planes& p, long long i) {
  SKey<NP> k;
#pragma unroll
  for (int q = 0; q < NP / 2; ++q)
    k.w[q] = kt_word(p[2 * q][i], p[2 * q + 1][i]);
  return k;
}

template <int NP>
__device__ __forceinline__ SKey<NP> skey_xor(const SKey<NP>& a, int m) {
  SKey<NP> r;
#pragma unroll
  for (int q = 0; q < NP / 2; ++q)
    r.w[q] = __shfl_xor_sync(SC_FULL, a.w[q], m);
  return r;
}

template <int NP>
__device__ __forceinline__ SKey<NP> skey_up1(const SKey<NP>& a) {
  SKey<NP> r;
#pragma unroll
  for (int q = 0; q < NP / 2; ++q)
    r.w[q] = __shfl_up_sync(SC_FULL, a.w[q], 1);
  return r;
}

__host__ __device__ constexpr int sc_log2(int x) {
  return x <= 1 ? 0 : 1 + sc_log2(x >> 1);
}

// Launch shape of segment size S: TPS threads a segment, BT a block (at
// least 256), MULTI when a segment spans warps.  Shared memory: each
// warp's 256 output lanes of one plane, staged for coalesced stores; for
// MULTI the exchange buffer in the same place (NP / 2 words of SC_ITEMS
// keys a thread), then each warp's last key and first boundary.  MIN_BLOCKS
// caps a wide segment of one warp at 64 registers, so that the 131,072
// threads of 2^20 lanes are one wave on 132 SMs.
template <int NP, int S> struct SCShape {
  static constexpr int TPS = S / SC_ITEMS;
  static constexpr int BT = TPS > 256 ? TPS : 256;
  static constexpr int NW = BT / 32;
  static constexpr bool MULTI = TPS > 32;
  static constexpr int MIN_BLOCKS = NP == 4 && !MULTI ? 4 : 1;
  static constexpr int XCH = MULTI ? BT * SC_ITEMS * (NP / 2) : 0;  // u64
  static constexpr size_t SMEM = MULTI
      ? (size_t)(XCH + NW * (NP / 2)) * 8 + NW * 4
      : (size_t)BT * SC_ITEMS * 4;
};

// One lane-crossing stage: v[j] keeps the min (low) or max of itself and
// the partner thread's (tid ^ m) item j, or item I - 1 - j (FLIP).
template <int NP, int S, bool FLIP, int I>
__device__ __forceinline__ void sc_exchange(SKey<NP> (&v)[I], int m,
                                            bool low, u64* xch) {
  if (!SCShape<NP, S>::MULTI || m < 32) {
    // a pair (j, I-1-j) at a time under FLIP, one item otherwise: few
    // partner keys live at once
#pragma unroll
    for (int j = 0; j < (FLIP ? I / 2 : I); ++j) {
      const SKey<NP> pj = skey_xor<NP>(v[FLIP ? I - 1 - j : j], m);
      if (FLIP) {
        const SKey<NP> pk = skey_xor<NP>(v[j], m);
        skey_keep<NP>(v[I - 1 - j], pk, low);
      }
      skey_keep<NP>(v[j], pj, low);
    }
    return;
  }
  constexpr int BT = SCShape<NP, S>::BT;
  const int t = threadIdx.x;
  SKey<NP> p[I];
#pragma unroll
  for (int j = 0; j < I; ++j)
#pragma unroll
    for (int q = 0; q < NP / 2; ++q) xch[(q * I + j) * BT + t] = v[j].w[q];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < I; ++j)
#pragma unroll
    for (int q = 0; q < NP / 2; ++q)
      p[j].w[q] = xch[(q * I + (FLIP ? I - 1 - j : j)) * BT + (t ^ m)];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < I; ++j) skey_keep<NP>(v[j], p[j], low);
}

// One tile of BT * SC_ITEMS lanes a block.  No early exit: every lane of a
// warp shuffles, and MULTI blocks meet at barriers.  SC_SORT_ONLY writes
// the sorted keys as they are and no counts; SC_COUNT_ONLY takes sorted
// 4096-lane chunks of segments of seg lanes (seg > S) and counts them.
template <int NP, int S, int MODE>
__global__ void __launch_bounds__(SCShape<NP, S>::BT,
                                  SCShape<NP, S>::MIN_BLOCKS)
kt_segment_count_kernel(SCIn<NP> in, long long n, long long n_pad,
                        bool aligned, SCOut<NP> out,
                        int* __restrict__ counts, long long seg) {
  using Sh = SCShape<NP, S>;
  constexpr int I = SC_ITEMS, TPS = Sh::TPS, LOG_S = sc_log2(S);
  extern __shared__ u64 sc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ts = tid & (TPS - 1);                      // thread in segment
  const int e0 = ts * I;                               // its first element
  const long long base = ((long long)blockIdx.x * Sh::BT + tid) * I;

  // load: 16-byte vectors where the thread's lanes all lie below n, else
  // one by one (invalid past n)
  SKey<NP> v[I];
  {
    u32 x[NP][I];
    const bool vec = aligned && base + I <= n;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const u32* src = in.p[q] + base;
      if (vec) {
#pragma unroll
        for (int h = 0; h < I / 4; ++h) {
          const uint4 t = __ldg(reinterpret_cast<const uint4*>(src) + h);
          x[q][4 * h] = t.x;
          x[q][4 * h + 1] = t.y;
          x[q][4 * h + 2] = t.z;
          x[q][4 * h + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < I; ++j)
          x[q][j] = base + j < n ? src[j] : (q == 0 ? KT_INVALID_HI : 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < I; ++j)
#pragma unroll
      for (int q = 0; q < NP / 2; ++q)
        v[j].w[q] = kt_word(x[2 * q][j], x[2 * q + 1][j]);
  }

  // bitonic network, all-ascending form
#pragma unroll
  for (int lk = 1; lk <= (MODE == SC_COUNT_ONLY ? 0 : LOG_S); ++lk) {
    const int kk = 1 << lk;
    if (kk <= I) {
#pragma unroll
      for (int j = 0; j < I; ++j)
        if ((j & (kk >> 1)) == 0) skey_cmpx<NP>(v[j], v[j ^ (kk - 1)]);
    } else {
      sc_exchange<NP, S, true>(v, kk / I - 1, (ts & (kk / I / 2)) == 0,
                               sc_smem);
    }
#pragma unroll
    for (int ls = lk - 2; ls >= 0; --ls) {
      const int s = 1 << ls;
      if (s < I) {
#pragma unroll
        for (int j = 0; j < I; ++j)
          if ((j & s) == 0) skey_cmpx<NP>(v[j], v[j | s]);
      } else {
        sc_exchange<NP, S, false>(v, s / I, (ts & (s / I)) == 0, sc_smem);
      }
    }
  }

  u32 o[NP + 1][I];
  if constexpr (MODE == SC_SORT_ONLY) {
#pragma unroll
    for (int j = 0; j < I; ++j)
#pragma unroll
      for (int q = 0; q < NP / 2; ++q) {
        o[2 * q][j] = (u32)(v[j].w[q] >> 32);
        o[2 * q + 1][j] = (u32)v[j].w[q];
      }
  } else {
    // run starts; boundaries = run starts and invalid lanes
    u64* wlast = sc_smem + Sh::XCH;                      // MULTI only
    int* wfirst = reinterpret_cast<int*>(wlast + Sh::NW * (NP / 2));
    SKey<NP> prev = skey_up1<NP>(v[I - 1]);              // previous lane's last
    if constexpr (Sh::MULTI) {
      if (lane == 31)
#pragma unroll
        for (int q = 0; q < NP / 2; ++q)
          wlast[warp * (NP / 2) + q] = v[I - 1].w[q];
      __syncthreads();
      if (lane == 0 && ts != 0)
#pragma unroll
        for (int q = 0; q < NP / 2; ++q)
          prev.w[q] = wlast[(warp - 1) * (NP / 2) + q];
    }
    bool linked = ts != 0;                               // prev in the segment
    if constexpr (MODE == SC_COUNT_ONLY) {
      if (ts == 0 && base % seg != 0) {
        prev = skey_at<NP>(in.p, base - 1);
        linked = true;
      }
    }
    bool valid[I], start[I];
    u32 bnd = 0;
#pragma unroll
    for (int j = 0; j < I; ++j) {
      valid[j] = (v[j].w[0] >> 63) == 0;
      const bool same = j ? skey_eq<NP>(v[j - 1], v[j])
                          : linked && skey_eq<NP>(prev, v[j]);
      start[j] = valid[j] && !same;
      if (start[j] || !valid[j]) bnd |= 1u << j;
    }

    // the first boundary after this thread's lanes in its segment (S if none)
    const int first = bnd ? e0 + __ffs(bnd) - 1 : S;
    const u32 any = __ballot_sync(SC_FULL, bnd != 0);
    u32 later = lane == 31 ? 0u : SC_FULL << (lane + 1);
    if constexpr (TPS < 32) later &= ((1u << TPS) - 1) << (lane & ~(TPS - 1));
    const u32 cand = any & later;
    int after = __shfl_sync(SC_FULL, first, cand ? __ffs(cand) - 1 : lane);
    if (!cand) after = S;
    if constexpr (Sh::MULTI) {
      const int wf = __shfl_sync(SC_FULL, first, any ? __ffs(any) - 1 : 0);
      if (lane == 0) wfirst[warp] = any ? wf : S;
      __syncthreads();
      constexpr int WPS = TPS / 32;                      // warps a segment
      if (!cand)
        for (int w = warp + 1; w <= (warp | (WPS - 1)); ++w)
          if (wfirst[w] < S) {
            after = wfirst[w];
            break;
          }
    }
    if constexpr (MODE == SC_COUNT_ONLY) {
      // the chunk's last run start, where its run goes on past the chunk:
      // the first larger key in the rest of the segment ends it
      const long long c0 = base - e0, s_end = (c0 / seg + 1) * seg;
      if (after == S && bnd && valid[I - 1] && c0 + S < s_end) {
        long long lo = c0 + S, hi = s_end;
        while (lo < hi) {
          const long long mid = (lo + hi) >> 1;
          if (skey_lt<NP>(v[I - 1], skey_at<NP>(in.p, mid))) hi = mid;
          else lo = mid + 1;
        }
        after = (int)(lo - c0);
      }
    }

    // outputs, then each plane through the warp's staging area: thread t
    // writes its I lanes, lane c stores 16-byte chunks c, c + 32, ...
#pragma unroll
    for (int j = 0; j < I; ++j) {
      const u32 rest = bnd & ~((2u << j) - 1);           // boundaries after j
      const int nb = rest ? e0 + __ffs(rest) - 1 : after;
      o[NP][j] = start[j] ? (u32)(nb - (e0 + j)) : 0u;
#pragma unroll
      for (int q = 0; q < NP / 2; ++q) {
        const u64 w = valid[j] ? v[j].w[q] : 0ull;
        o[2 * q][j] = (u32)(w >> 32);
        o[2 * q + 1][j] = (u32)w;
      }
    }
  }
  uint4* stage = reinterpret_cast<uint4*>(sc_smem) + warp * (32 * I / 4);
  const long long wbase = base - (long long)lane * I;  // the warp's first lane
#pragma unroll
  for (int q = 0; q < (MODE == SC_SORT_ONLY ? NP : NP + 1); ++q) {
#pragma unroll
    for (int h = 0; h < I / 4; ++h)
      stage[lane * (I / 4) + h] = make_uint4(o[q][4 * h], o[q][4 * h + 1],
                                             o[q][4 * h + 2], o[q][4 * h + 3]);
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(
        (q < NP ? out.p[q] : reinterpret_cast<u32*>(counts)) + wbase);
#pragma unroll
    for (int h = 0; h < I / 4; ++h) {
      const int c = lane + 32 * h;
      if (wbase + 4 * c < n_pad) dst[c] = stage[c];
    }
    __syncwarp();
  }
}

// the largest segment's block fits in an SM's shared memory (227 KB)
static_assert(SCShape<4, SC_MAX_SEG>::SMEM <= 227 * 1024, "SC_MAX_SEG");

// Number of A lanes among the first d lanes of the merge of A and B (na
// and nb sorted lanes, A first on equal keys), as merge.cu's kt_merge_path.
template <int NP, typename KeyA, typename KeyB>
__device__ __forceinline__ int sc_merge_path(KeyA ka, int na, KeyB kb, int nb,
                                             int d) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!skey_lt<NP>(kb(d - 1 - mid), ka(mid))) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One merge round: the sorted runs of `run` lanes pair up, [2 r run, (2 r
// + 1) run) with the next run, into runs of 2 run lanes.  A block merges
// MR_TILE output lanes of one pair: its first two threads find the
// block's split in global memory, the block loads the A window and then
// the B window (exactly MR_TILE lanes) into shared memory, each thread
// finds its own SC_ITEMS output lanes' split there and merges them, and
// the tile goes back through shared memory in coalesced stores.
template <int NP>
__global__ void __launch_bounds__(MR_THREADS)
kt_segment_merge_kernel(SCIn<NP> in, SCOut<NP> out, int run) {
  __shared__ u32 sw[NP][MR_TILE];
  __shared__ int split[2];
  const int tid = threadIdx.x;
  const long long d0 = (long long)blockIdx.x * MR_TILE;
  const long long pair = d0 & ~(2ll * run - 1);
  const int d = (int)(d0 - pair);
  if (tid < 2) {
    split[tid] = sc_merge_path<NP>(
        [&](int i) { return skey_at<NP>(in.p, pair + i); }, run,
        [&](int i) { return skey_at<NP>(in.p, pair + run + i); }, run,
        d + tid * MR_TILE);
  }
  __syncthreads();
  const int a0 = split[0], wa = split[1] - a0, wb = MR_TILE - wa;
  const long long b0 = pair + run + (d - a0);
  for (int i = tid; i < MR_TILE; i += MR_THREADS) {
    const long long g = i < wa ? pair + a0 + i : b0 + (i - wa);
#pragma unroll
    for (int q = 0; q < NP; ++q) sw[q][i] = in.p[q][g];
  }
  __syncthreads();
  auto ka = [&](int i) { return skey_at<NP>(sw, i); };
  auto kb = [&](int i) { return skey_at<NP>(sw, wa + i); };
  const int di = tid * SC_ITEMS;
  int ai = sc_merge_path<NP>(ka, wa, kb, wb, di), bi = di - ai;
  u32 r[NP][SC_ITEMS];
#pragma unroll
  for (int it = 0; it < SC_ITEMS; ++it) {
    const bool take_a = bi >= wb || (ai < wa && !skey_lt<NP>(kb(bi), ka(ai)));
    const int src = take_a ? ai++ : wa + bi++;
#pragma unroll
    for (int q = 0; q < NP; ++q) r[q][it] = sw[q][src];
  }
  __syncthreads();  // every thread is done reading the windows
#pragma unroll
  for (int it = 0; it < SC_ITEMS; ++it)
#pragma unroll
    for (int q = 0; q < NP; ++q) sw[q][di + it] = r[q][it];
  __syncthreads();
  for (int i = tid; i < MR_TILE; i += MR_THREADS)
#pragma unroll
    for (int q = 0; q < NP; ++q) out.p[q][d0 + i] = sw[q][i];
}

template <int NP, int S, int MODE>
static int kt_segment_launch(const void* const* in, long long n,
                             long long n_pad, void* const* out, void* counts,
                             long long seg, cudaStream_t st) {
  using Sh = SCShape<NP, S>;
  SCIn<NP> a;
  SCOut<NP> o;
  bool aligned = true;
  for (int q = 0; q < NP; ++q) {
    a.p[q] = (const u32*)in[q];
    o.p[q] = (u32*)out[q];
    aligned = aligned && ((uintptr_t)in[q] & 15) == 0;
  }
  if constexpr (Sh::SMEM > 48 * 1024) {
    // above the static limit once a device (a benign race: both set it)
    static unsigned long long raised = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!((raised >> dev) & 1)) {
      err = cudaFuncSetAttribute(kt_segment_count_kernel<NP, S, MODE>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)Sh::SMEM);
      if (err != cudaSuccess) return (int)err;
      raised |= 1ull << dev;
    }
  }
  const long long per_block = (long long)Sh::BT * SC_ITEMS;
  const long long blocks = (n_pad + per_block - 1) / per_block;
  kt_segment_count_kernel<NP, S, MODE>
      <<<(unsigned)blocks, Sh::BT, Sh::SMEM, st>>>(a, n, n_pad, aligned, o,
                                                   (int*)counts, seg);
  return (int)cudaGetLastError();
}

// Segments past SC_MAX_SEG lanes (seg a power of two dividing n_pad): the
// tile pass, log2(seg / SC_MAX_SEG) merge rounds and the count pass.  Pass
// p (0 the tile pass, 1 .. rounds the merge rounds) writes the scratch
// planes where rounds - p is even, else the output planes, so that the
// count pass reads the scratch and writes the outputs.
template <int NP>
static int kt_segment_large(const void* const* in, long long n,
                            long long n_pad, long long seg, void* const* out,
                            void* counts, void* scratch, cudaStream_t st) {
  if ((seg & (seg - 1)) || n_pad % seg || seg > (1ll << 30) || !scratch)
    return (int)cudaErrorInvalidValue;
  void* sp[NP];
  for (int q = 0; q < NP; ++q) sp[q] = (u32*)scratch + q * n_pad;
  int rounds = 0;
  while ((SC_MAX_SEG << rounds) < seg) ++rounds;
  auto buf = [&](int p) { return (rounds - p) % 2 == 0 ? sp : out; };
  int err = kt_segment_launch<NP, SC_MAX_SEG, SC_SORT_ONLY>(
      in, n, n_pad, buf(0), nullptr, seg, st);
  if (err) return err;
  for (int p = 1; p <= rounds; ++p) {
    SCIn<NP> a;
    SCOut<NP> o;
    for (int q = 0; q < NP; ++q) {
      a.p[q] = (const u32*)buf(p - 1)[q];
      o.p[q] = (u32*)buf(p)[q];
    }
    kt_segment_merge_kernel<NP><<<(unsigned)(n_pad / MR_TILE), MR_THREADS, 0,
                                  st>>>(a, o, SC_MAX_SEG << (p - 1));
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return kt_segment_launch<NP, SC_MAX_SEG, SC_COUNT_ONLY>(
      sp, n_pad, n_pad, out, counts, seg, st);
}

template <int NP>
static int kt_segment_dispatch(const void* const* in, long long n,
                               long long n_pad, long long seg_lanes,
                               void* const* out, void* counts, void* scratch,
                               cudaStream_t st) {
#define SC_CASE(S)                                                       \
  case S:                                                                \
    return kt_segment_launch<NP, S, SC_SORT_COUNT>(in, n, n_pad, out,    \
                                                   counts, S, st);
  switch (seg_lanes) {
    SC_CASE(8) SC_CASE(16) SC_CASE(32) SC_CASE(64) SC_CASE(128)
    SC_CASE(256) SC_CASE(512) SC_CASE(1024) SC_CASE(2048) SC_CASE(4096)
    default:
      if (seg_lanes < SC_MAX_SEG) return (int)cudaErrorInvalidValue;
      return kt_segment_large<NP>(in, n, n_pad, seg_lanes, out, counts,
                                  scratch, st);
  }
#undef SC_CASE
}

// n_planes 2 or 4 (pointers past n_planes are ignored); seg_lanes a power
// of two from 8 up; n_pad a multiple of seg_lanes; outputs n_pad lanes
// each, 16-byte aligned.  Past SC_MAX_SEG lanes, scratch holds n_planes x
// n_pad uint32 lanes (16-byte aligned); else it is unused and may be null.
KT_EXPORT int kt_segment_count(const void* in0, const void* in1,
                               const void* in2, const void* in3, long long n,
                               long long n_pad, long long seg_lanes,
                               int n_planes, void* out0, void* out1,
                               void* out2, void* out3, void* counts,
                               void* scratch, void* stream) {
  if (n_pad == 0) return 0;
  const void* in[4] = {in0, in1, in2, in3};
  void* out[4] = {out0, out1, out2, out3};
  cudaStream_t st = (cudaStream_t)stream;
  if (n_planes == 2)
    return kt_segment_dispatch<2>(in, n, n_pad, seg_lanes, out, counts,
                                  scratch, st);
  if (n_planes == 4)
    return kt_segment_dispatch<4>(in, n, n_pad, seg_lanes, out, counts,
                                  scratch, st);
  return (int)cudaErrorInvalidValue;
}
