// K11: ascending sort of 64-bit keys held as two uint32 planes (hi, lo),
// as unsigned values (uint64)hi << 32 | lo.  No payload.
//
// Replaces kmers_tpu/kernels/sort.py:bitonic_sort_u64 (its Pallas tile
// kernel _tile_sort_kernel and merge pass _intra_pass_kernel).  The TPU
// kernel is a bitonic network because Mosaic has no data-dependent
// addressing; it needs a power-of-two n (count.py pads with all-ones
// keys).  On Hopper the job is a least-significant-digit radix sort of
// 8-bit digits over ping-pong buffers, any n < 2^30, no padding.
//
// Bound: device-memory bytes.  The least traffic is one read and one
// write of the keys (16 B a key).  A radix pass must read and write every
// key, 16 B a key a pass, so this design moves 8 B a key for the census
// plus 16 B a key for each digit on which the keys differ: 136 B a key
// for random 62-bit keys with the invalid flag at bit 63 (every digit
// differs), plus the look-back's reads of 1 KB status rows.
//
// The design is onesweep (Adinets and Merrill, 2022): no per-pass
// histogram or scan kernel, and no host sync.
//   1. Census: one read of the keys counts all eight digits.  The last
//      block to finish turns the counts, on the device, into every digit's
//      global base for every pass and the pass plan: which digits differ,
//      and so where each pass reads and writes.
//   2. One kernel for each of the eight digits, launched whatever the
//      plan.  A pass whose digit is the same for all keys exits at once;
//      the others ping-pong between `tmp` and `out` so that the last one
//      lands in `out` (pass 0 copies the input to `out` when no digit
//      differs).  9 launches and one memset of the scratch a call.
//   3. Within a pass, a block takes its tile from an atomic ticket (so a
//      tile's predecessors are all resident: the look-back cannot wait on
//      a block that has not started), loads OS_TILE keys warp-striped and
//      ranks them by digit, stably in index order: per round of 32 keys a
//      warp finds each key's peers by eight ballots and counts them into
//      its own 256 bins in shared memory.  The tile publishes its count of
//      each digit (flag AGGREGATE); then thread d reads the status words
//      of OS_LOOKBACK earlier tiles at a time, adding their counts until it
//      meets an inclusive prefix (flag PREFIX), and publishes its own.  The
//      keys are staged in shared memory in digit order and written out by
//      consecutive threads to consecutive addresses within each digit's
//      run.
// The status word packs its flag and its count into one 32-bit store, so
// no fence orders them; the look-back reads it volatile.  Keys past n in
// the ragged last tile load as all-ones: digit 255, after every real key,
// so they fill the tile's last slots and are never written.
//
// What holds it back (PERF.md, section 6; chip_smoke.py's phase 12 times
// each kernel): a pass takes 9 us at 2^18 keys (64 tiles) and 17 us at
// 2^20 (256 tiles, all resident at once), where its bytes need 1-5 us, so
// there a pass is one tile's latency; at 2^24 a pass moves 268 MB at
// 43 % of the HBM rate, three blocks an SM (80 registers) in flight.

#include "common.cuh"

#define OS_THREADS 256
#define OS_WARPS (OS_THREADS / 32)
#define OS_ITEMS 16
#define OS_TILE (OS_THREADS * OS_ITEMS)
#define OS_BINS 256
#define OS_PASSES 8
#define OS_FULL 0xFFFFFFFFu
#define OS_AGGREGATE 0x40000000u    // the tile's own count of the digit
#define OS_PREFIX 0x80000000u       // the count over tiles 0 .. this one
#define OS_VALUE 0x3FFFFFFFu
// census blocks: at least OS_CENSUS_KEYS keys a thread, at most
// OS_CENSUS_BLOCKS blocks; each block adds 2048 counts to the global
// histogram by atomics, which fewer blocks keep cheap at 2^20 keys
#define OS_CENSUS_KEYS 16
#define OS_CENSUS_BLOCKS (132 * 8)
#define OS_LOOKBACK 8       // predecessor tiles a look-back step reads at once
#define OS_MIN_BLOCKS 3     // resident onesweep blocks an SM (registers)

// The head of the scratch buffer; the status words follow it,
// [OS_PASSES][n_tiles][OS_BINS].  All of it is zeroed before the census.
struct OsScratch {
  u32 hist[OS_PASSES * OS_BINS];   // census: keys with byte p == d
  u32 base[OS_PASSES * OS_BINS];   // first output slot of digit d, pass p
  int plan[16];     // [p]: ordinal of pass p among the passes run, or -1;
                    // [OS_PASSES]: the number of passes run
  u32 ticket[16];   // [p]: tiles taken in pass p; [OS_PASSES]: census
                    // blocks done
};

__device__ __forceinline__ u32 os_load(const u32* p) {
  return *(const volatile u32*)p;
}

__device__ __forceinline__ void os_store(u32* p, u32 v) {
  *(volatile u32*)p = v;
}

// Exclusive sum of v over the block's threads in thread order.
__device__ __forceinline__ u32 os_block_exclusive_sum(u32 v, u32* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u32 x = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const u32 up = __shfl_up_sync(OS_FULL, x, s);
    if (lane >= s) x += up;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  u32 before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ u32 os_digit(u32 kh, u32 kl, int pass) {
  return ((pass >= 4 ? kh : kl) >> (8 * (pass & 3))) & 0xFFu;
}

// Census of all eight digits in one read; the last block makes the plan.
__global__ void __launch_bounds__(OS_THREADS)
kt_radix_census_kernel(const u32* __restrict__ hi, const u32* __restrict__ lo,
                       long long n, OsScratch* sc) {
  __shared__ u32 h[OS_PASSES * OS_BINS];
  __shared__ u32 warp_sum[OS_WARPS];
  __shared__ int differs[OS_PASSES];
  __shared__ bool last;
  for (int i = threadIdx.x; i < OS_PASSES * OS_BINS; i += OS_THREADS) h[i] = 0;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * OS_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * OS_THREADS) {
    const u32 l = lo[i], hh = hi[i];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      atomicAdd(&h[p * OS_BINS + ((l >> (8 * p)) & 0xFFu)], 1u);
      atomicAdd(&h[(p + 4) * OS_BINS + ((hh >> (8 * p)) & 0xFFu)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < OS_PASSES * OS_BINS; i += OS_THREADS)
    if (h[i]) atomicAdd(&sc->hist[i], h[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&sc->ticket[OS_PASSES], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int d = threadIdx.x;
  for (int p = 0; p < OS_PASSES; ++p) {
    const u32 c = os_load(&sc->hist[p * OS_BINS + d]);
    sc->base[p * OS_BINS + d] = os_block_exclusive_sum(c, warp_sum);
    const int trivial = __syncthreads_or(c == (u32)n);
    if (d == 0) differs[p] = !trivial;
  }
  __syncthreads();
  if (d == 0) {
    int m = 0;
    for (int p = 0; p < OS_PASSES; ++p) sc->plan[p] = differs[p] ? m++ : -1;
    sc->plan[OS_PASSES] = m;
  }
}

// One LSD pass on the digit of byte `pass` (0 least significant).
__global__ void __launch_bounds__(OS_THREADS, OS_MIN_BLOCKS)
kt_radix_onesweep_kernel(const u32* __restrict__ in_hi,
                         const u32* __restrict__ in_lo, u32* out_hi,
                         u32* out_lo, u32* tmp_hi, u32* tmp_lo, long long n,
                         int pass, OsScratch* sc, u32* status_all,
                         int n_tiles) {
  __shared__ u32 s_hi[OS_TILE], s_lo[OS_TILE];  // the tile in digit order
  __shared__ u32 whist[OS_WARPS][OS_BINS];   // per warp: count, then offset
  __shared__ u32 tile_start[OS_BINS];        // the digit's first tile slot
  __shared__ u32 gofs[OS_BINS];              // tile slot -> output index
  __shared__ u32 warp_sum[OS_WARPS];
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ord = sc->plan[pass], m = sc->plan[OS_PASSES];
  if (ord < 0) {
    if (pass == 0 && m == 0) {                // every key is the same
      const long long t0 = (long long)blockIdx.x * OS_TILE;
      for (int j = tid; j < OS_TILE && t0 + j < n; j += OS_THREADS) {
        out_hi[t0 + j] = in_hi[t0 + j];
        out_lo[t0 + j] = in_lo[t0 + j];
      }
    }
    return;
  }
  // passes run 0 .. m-1 ping-pong so that pass m-1 writes `out`
  u32* dst_hi = ((m - 1 - ord) & 1) ? tmp_hi : out_hi;
  u32* dst_lo = ((m - 1 - ord) & 1) ? tmp_lo : out_lo;
  const u32* src_hi = ord == 0 ? in_hi : (((m - ord) & 1) ? tmp_hi : out_hi);
  const u32* src_lo = ord == 0 ? in_lo : (((m - ord) & 1) ? tmp_lo : out_lo);

  if (tid == 0) s_tile = (int)atomicAdd(&sc->ticket[pass], 1u);
  for (int i = tid; i < OS_WARPS * OS_BINS; i += OS_THREADS)
    (&whist[0][0])[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long t0 = (long long)tile * OS_TILE;
  const int n_real = (int)(n - t0 < OS_TILE ? n - t0 : OS_TILE);

  // warp w holds keys t0 + w * 32 * OS_ITEMS + r * 32 + lane, r < OS_ITEMS
  u32 kh[OS_ITEMS], kl[OS_ITEMS], rank[OS_ITEMS];
  const long long w0 = t0 + (long long)warp * 32 * OS_ITEMS + lane;
#pragma unroll
  for (int r = 0; r < OS_ITEMS; ++r) {
    const long long i = w0 + r * 32;
    kh[r] = i < n ? src_hi[i] : OS_FULL;
    kl[r] = i < n ? src_lo[i] : OS_FULL;
  }
  u32* wh = whist[warp];
  const u32 lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < OS_ITEMS; ++r) {
    const u32 d = os_digit(kh[r], kl[r], pass);
    u32 peers = OS_FULL;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const bool bit = (d >> b) & 1u;
      const u32 vote = __ballot_sync(OS_FULL, bit);
      peers &= bit ? vote : ~vote;
    }
    const u32 before = wh[d];
    rank[r] = before + __popc(peers & lanes_below);
    __syncwarp();
    if ((peers & lanes_below) == 0) wh[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // thread tid owns digit tid: warp offsets in warp order, the tile's count
  u32 count = 0;
#pragma unroll
  for (int w = 0; w < OS_WARPS; ++w) {
    const u32 c = whist[w][tid];
    whist[w][tid] = count;
    count += c;
  }
  u32* status = status_all + ((long long)pass * n_tiles + tile) * OS_BINS;
  os_store(&status[tid], (tile == 0 ? OS_PREFIX : OS_AGGREGATE) | count);
  // Look back from tile - 1, OS_LOOKBACK tiles a step: add aggregates
  // until a prefix; a tile that has published nothing yet is read again.
  u32 excl = 0;
  if (tile > 0) {
    const u32* rows = status_all + (long long)pass * n_tiles * OS_BINS + tid;
    int t = tile - 1;
    for (bool done = false; !done;) {
      u32 s[OS_LOOKBACK];
#pragma unroll
      for (int i = 0; i < OS_LOOKBACK; ++i)
        s[i] = t - i >= 0 ? os_load(rows + (long long)(t - i) * OS_BINS)
                          : OS_PREFIX;
      int ready = 0;
#pragma unroll
      for (int i = 0; i < OS_LOOKBACK; ++i) {
        if (done || ready < i || !(s[i] & (OS_AGGREGATE | OS_PREFIX)))
          continue;
        excl += s[i] & OS_VALUE;
        done = s[i] & OS_PREFIX;
        ready = i + 1;
      }
      t -= ready;
    }
    os_store(&status[tid], OS_PREFIX | (excl + count));
  }
  const u32 start = os_block_exclusive_sum(count, warp_sum);
  tile_start[tid] = start;
  gofs[tid] = sc->base[pass * OS_BINS + tid] + excl - start;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < OS_ITEMS; ++r) {
    const u32 d = os_digit(kh[r], kl[r], pass);
    const u32 at = tile_start[d] + wh[d] + rank[r];
    s_hi[at] = kh[r];
    s_lo[at] = kl[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < OS_ITEMS; ++r) {
    const int j = r * OS_THREADS + tid;
    if (j < n_real) {
      const u32 h = s_hi[j], l = s_lo[j];
      const u32 at = gofs[os_digit(h, l, pass)] + j;
      dst_hi[at] = h;
      dst_lo[at] = l;
    }
  }
}

static long long kt_radix_tiles(long long n) {
  return (n + OS_TILE - 1) / OS_TILE;
}

KT_EXPORT int kt_radix_tile() { return OS_TILE; }

// Bytes of scratch kt_radix_sort needs for n keys.
KT_EXPORT long long kt_radix_scratch_bytes(long long n) {
  return (long long)sizeof(OsScratch) +
         4LL * OS_PASSES * OS_BINS * kt_radix_tiles(n);
}

// in -> out, sorted; tmp: n-key planes; scratch: kt_radix_scratch_bytes(n)
// bytes.  n < 2^30 (the status word's count field).
KT_EXPORT int kt_radix_sort(const void* in_hi, const void* in_lo, long long n,
                            void* out_hi, void* out_lo, void* tmp_hi,
                            void* tmp_lo, void* scratch, void* stream) {
  if (n == 0) return 0;
  if (n > OS_VALUE) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_tiles = kt_radix_tiles(n);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, (size_t)kt_radix_scratch_bytes(n), st);
  if (err != cudaSuccess) return (int)err;
  OsScratch* sc = (OsScratch*)scratch;
  u32* status = (u32*)(sc + 1);
  const long long blocks =
      (n + OS_THREADS * OS_CENSUS_KEYS - 1) / (OS_THREADS * OS_CENSUS_KEYS);
  kt_radix_census_kernel<<<(unsigned)(blocks < OS_CENSUS_BLOCKS
                                          ? blocks
                                          : OS_CENSUS_BLOCKS),
                           OS_THREADS, 0, st>>>((const u32*)in_hi,
                                                (const u32*)in_lo, n, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int pass = 0; pass < OS_PASSES; ++pass) {
    kt_radix_onesweep_kernel<<<(unsigned)n_tiles, OS_THREADS, 0, st>>>(
        (const u32*)in_hi, (const u32*)in_lo, (u32*)out_hi, (u32*)out_lo,
        (u32*)tmp_hi, (u32*)tmp_lo, n, pass, sc, status, (int)n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
