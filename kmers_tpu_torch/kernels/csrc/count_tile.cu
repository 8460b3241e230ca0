// K10: segment-local sort and run-length count of folded k-mer keys.
//
// Replaces kmers_tpu/kernels/count_tile.py: segment_count_keys (2 key
// planes, k <= 31) and segment_count_keys_wide (4 planes, 33 <= k <= 63),
// both _segment_count -> _count_tile_kernel.  Keys are NP uint32 planes,
// plane 0 most significant, with the invalid flag folded into bit 31 of
// plane 0 (an invalid lane is exactly (0x80000000, 0[, 0, 0])).  For each
// S-lane segment (S = seg_lanes) of the n_pad output lanes (n_pad = n
// rounded up to block_lanes; lanes past n are invalid): the segment's keys
// ascending, valid first; counts = the run length at each run start and 0
// elsewhere; invalid lanes all zero (keys & valid mask, so the flag is
// cleared too).  Run boundaries are the run starts and the first invalid
// lane (count_tile.py:171-191).
//
// Bound: device-memory bytes, 4 NP bytes in and 4 (NP + 1) out a lane (20
// B narrow, 36 B wide) against ~log2(S)^2 / 2 compare-exchanges a lane.
// The TPU kernel sorted many segments at once in one [rows, 128] block
// with rolls and selects, because Mosaic pays per vector op.  Here one
// warp owns one segment: ITEMS = S / 32 keys a thread in registers, element
// e = j * 32 + lane.  A bitonic stage at stride s < 32 exchanges through
// __shfl_xor_sync, a stage at s >= 32 swaps two registers of one thread;
// direction from (e & kk), as the TPU network.  Run starts compare each
// element with element e - 1 (a shuffle up; lane 0 takes lane 31 of the
// previous register), and each start finds the next boundary in the
// warp's ballot masks with __ffs.  Keys never leave registers between the
// one coalesced read and the one coalesced write.

#include "common.cuh"

#define SC_WARPS 8
#define SC_FULL 0xFFFFFFFFu

template <int N> struct SCIn { const u32* p[N]; };
template <int N> struct SCOut { u32* p[N]; };

// NP planes as NP / 2 64-bit words, most significant first.
template <int NP> struct SKey { u64 w[NP / 2]; };

template <int NP>
__device__ __forceinline__ bool skey_lt(const SKey<NP>& a, const SKey<NP>& b) {
#pragma unroll
  for (int q = 0; q + 1 < NP / 2; ++q)
    if (a.w[q] != b.w[q]) return a.w[q] < b.w[q];
  return a.w[NP / 2 - 1] < b.w[NP / 2 - 1];
}

template <int NP>
__device__ __forceinline__ bool skey_eq(const SKey<NP>& a, const SKey<NP>& b) {
  bool eq = true;
#pragma unroll
  for (int q = 0; q < NP / 2; ++q) eq = eq && a.w[q] == b.w[q];
  return eq;
}

template <int NP>
__device__ __forceinline__ SKey<NP> skey_xor(const SKey<NP>& a, int m) {
  SKey<NP> r;
#pragma unroll
  for (int q = 0; q < NP / 2; ++q) r.w[q] = __shfl_xor_sync(SC_FULL, a.w[q], m);
  return r;
}

template <int NP>
__device__ __forceinline__ SKey<NP> skey_up1(const SKey<NP>& a) {
  SKey<NP> r;
#pragma unroll
  for (int q = 0; q < NP / 2; ++q) r.w[q] = __shfl_up_sync(SC_FULL, a.w[q], 1);
  return r;
}

template <int NP>
__device__ __forceinline__ SKey<NP> skey_lane(const SKey<NP>& a, int src) {
  SKey<NP> r;
#pragma unroll
  for (int q = 0; q < NP / 2; ++q) r.w[q] = __shfl_sync(SC_FULL, a.w[q], src);
  return r;
}

template <int NP, int ITEMS>
__global__ void __launch_bounds__(SC_WARPS * 32)
kt_segment_count_kernel(SCIn<NP> in, long long n, long long n_seg,
                        SCOut<NP> out, int* __restrict__ counts) {
  constexpr int S = 32 * ITEMS;
  constexpr int LOG_S = ITEMS == 1 ? 5 : ITEMS == 2 ? 6 : ITEMS == 4 ? 7 : 8;
  const int lane = threadIdx.x & 31;
  const long long seg = (long long)blockIdx.x * SC_WARPS + (threadIdx.x >> 5);
  if (seg >= n_seg) return;                  // the whole warp leaves
  const long long base = seg * S;

  SKey<NP> v[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * 32 + lane;
#pragma unroll
    for (int q = 0; q < NP / 2; ++q)
      v[j].w[q] = i < n ? kt_word(in.p[2 * q][i], in.p[2 * q + 1][i])
                        : (q == 0 ? (u64)KT_INVALID_HI << 32 : 0ull);
  }

  // bitonic network over the S elements of the segment
#pragma unroll
  for (int lk = 1; lk <= LOG_S; ++lk) {
    const int kk = 1 << lk;
#pragma unroll
    for (int ls = lk - 1; ls >= 0; --ls) {
      const int s = 1 << ls;
      if (s >= 32) {
        const int js = s >> 5;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          if (j & js) continue;
          const bool asc = ((j * 32) & kk) == 0;
          const bool swap = asc ? skey_lt<NP>(v[j | js], v[j])
                                : skey_lt<NP>(v[j], v[j | js]);
          if (swap) {
            const SKey<NP> t = v[j];
            v[j] = v[j | js];
            v[j | js] = t;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          const SKey<NP> p = skey_xor<NP>(v[j], s);
          const int e = j * 32 + lane;
          const bool want_small = ((e & s) == 0) == ((e & kk) == 0);
          const bool take = want_small ? skey_lt<NP>(p, v[j])
                                       : skey_lt<NP>(v[j], p);
          if (take) v[j] = p;
        }
      }
    }
  }

  // run starts and boundaries (run starts and invalid lanes)
  bool start[ITEMS], valid[ITEMS];
  u32 bmask[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const SKey<NP> up = skey_up1<NP>(v[j]);
    const SKey<NP> carried = skey_lane<NP>(v[j > 0 ? j - 1 : 0], 31);
    const SKey<NP> prev = lane == 0 ? carried : up;
    valid[j] = (v[j].w[0] >> 63) == 0;
    const bool first = j == 0 && lane == 0;
    start[j] = valid[j] && (first || !skey_eq<NP>(prev, v[j]));
    bmask[j] = __ballot_sync(SC_FULL, start[j] || !valid[j]);
  }

#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * 32 + lane;
    int count = 0;
    if (start[j]) {
      const u32 after = lane == 31 ? 0u : bmask[j] & (SC_FULL << (lane + 1));
      int nb = S;
      if (after) {
        nb = j * 32 + __ffs(after) - 1;
      } else {
#pragma unroll
        for (int jj = ITEMS - 1; jj > j; --jj)
          if (bmask[jj]) nb = jj * 32 + __ffs(bmask[jj]) - 1;
      }
      count = nb - (j * 32 + lane);
    }
    counts[i] = count;
#pragma unroll
    for (int q = 0; q < NP / 2; ++q) {
      const u64 w = valid[j] ? v[j].w[q] : 0ull;
      out.p[2 * q][i] = (u32)(w >> 32);
      out.p[2 * q + 1][i] = (u32)w;
    }
  }
}

template <int NP, int ITEMS>
static int kt_segment_launch(const void* const* in, long long n,
                             long long n_pad, void* const* out, void* counts,
                             cudaStream_t st) {
  SCIn<NP> a;
  SCOut<NP> o;
  for (int q = 0; q < NP; ++q) {
    a.p[q] = (const u32*)in[q];
    o.p[q] = (u32*)out[q];
  }
  const long long n_seg = n_pad / (32 * ITEMS);
  const long long blocks = (n_seg + SC_WARPS - 1) / SC_WARPS;
  kt_segment_count_kernel<NP, ITEMS><<<(unsigned)blocks, SC_WARPS * 32, 0,
                                       st>>>(a, n, n_seg, o, (int*)counts);
  return (int)cudaGetLastError();
}

template <int NP>
static int kt_segment_dispatch(const void* const* in, long long n,
                               long long n_pad, int seg_lanes,
                               void* const* out, void* counts,
                               cudaStream_t st) {
  switch (seg_lanes) {
    case 32: return kt_segment_launch<NP, 1>(in, n, n_pad, out, counts, st);
    case 64: return kt_segment_launch<NP, 2>(in, n, n_pad, out, counts, st);
    case 128: return kt_segment_launch<NP, 4>(in, n, n_pad, out, counts, st);
    case 256: return kt_segment_launch<NP, 8>(in, n, n_pad, out, counts, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// n_planes 2 or 4 (pointers past n_planes are ignored); n_pad a multiple
// of seg_lanes in {32, 64, 128, 256}; outputs n_pad lanes each.
KT_EXPORT int kt_segment_count(const void* in0, const void* in1,
                               const void* in2, const void* in3, long long n,
                               long long n_pad, int seg_lanes, int n_planes,
                               void* out0, void* out1, void* out2, void* out3,
                               void* counts, void* stream) {
  if (n_pad == 0) return 0;
  const void* in[4] = {in0, in1, in2, in3};
  void* out[4] = {out0, out1, out2, out3};
  cudaStream_t st = (cudaStream_t)stream;
  if (n_planes == 2)
    return kt_segment_dispatch<2>(in, n, n_pad, seg_lanes, out, counts, st);
  if (n_planes == 4)
    return kt_segment_dispatch<4>(in, n, n_pad, seg_lanes, out, counts, st);
  return (int)cudaErrorInvalidValue;
}
