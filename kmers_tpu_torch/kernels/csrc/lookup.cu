// K12: the count of each query word in a compact count table, by a
// lower-bound binary search of the query's (hi, lo) halves as unsigned
// 32-bit values over the table's first n_unique slots.
//
// Replaces no TPU kernel.  The JAX package's count.lookup
// (kmers_tpu/parallel/count.py:574) is a jnp binary search that XLA
// lowers to log2(capacity) rounds of gathers; the port first ran it as
// torch.searchsorted over the table's keys joined into int64 words, which
// wrote the whole joined key array (8 B a slot) on every call.  This
// kernel searches the table's int32 planes as they are: no joined array
// and no sign flip, so k = 32 keys with bit 63 set order correctly.
//
// Bound: each query (8 B), its valid byte and its answer (4 B) cross
// device memory once: 13 B a lane, 0.0041 ms at 2^20 lanes and
// 3.35 TB/s.  The search itself is bound by random 32-byte sector reads
// in L2: about log2(n_unique) probes a lane at unrelated places of the
// keys, of which the first ten or so are the same few slots for every
// lane and stay in L1.  So a probe reads the hi plane alone (4 B) and
// the lo plane only where the hi values tie (at k = 31 nearly every hi is
// unique), and the hi plane of the benchmark's 8.3M keys (33 MB) fits
// the 50 MB L2.  One lane a thread: carrying 2, 4 or 8 lanes a thread
// through the search in step, or a copy of the search tree's top 11
// levels in each block's shared memory, measured no faster, and a bucket
// directory of the keys built on every call within 10 % (PERF.md,
// section 6, K12).  Invalid lanes do no search and answer -1.

#include "common.cuh"

#define LK_THREADS 256

__global__ void __launch_bounds__(LK_THREADS)
    kt_search_counts_kernel(const u32* __restrict__ hi,
                            const u32* __restrict__ lo,
                            const int* __restrict__ counts, int nu,
                            const long long* __restrict__ queries,
                            const uint8_t* __restrict__ valid,
                            int* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)LK_THREADS + threadIdx.x;
  if (i >= n) return;
  if (valid != nullptr && !valid[i]) {
    out[i] = -1;
    return;
  }
  const u64 q = (u64)queries[i];
  const u32 qh = (u32)(q >> 32), ql = (u32)q;
  int a = 0, e = nu;           // the lower bound of q lies in [a, e]
  while (a < e) {
    const int mid = (int)(((unsigned)a + (unsigned)e) >> 1);
    const u32 h = hi[mid];
    if (h < qh || (h == qh && lo[mid] < ql))
      a = mid + 1;
    else
      e = mid;
  }
  out[i] = (a < nu && hi[a] == qh && lo[a] == ql) ? counts[a] : 0;
}

// out[i] = the count of queries[i] among the first nu slots of the table
// (hi, lo, counts: int32 planes, keys ascending as unsigned (hi, lo)), 0
// if absent, -1 where valid (a byte a lane, or null: all valid) is 0.
// 0 <= nu < 2^31, n < 2^39.
KT_EXPORT int kt_search_counts(const void* hi, const void* lo,
                               const void* counts, long long nu,
                               const void* queries, const void* valid,
                               void* out, long long n, void* stream) {
  if (n == 0) return 0;
  if (nu < 0 || nu >= (1LL << 31) ||
      (n + LK_THREADS - 1) / LK_THREADS >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  kt_search_counts_kernel<<<(unsigned)((n + LK_THREADS - 1) / LK_THREADS),
                            LK_THREADS, 0, (cudaStream_t)stream>>>(
      (const u32*)hi, (const u32*)lo, (const int*)counts, (int)nu,
      (const long long*)queries, (const uint8_t*)valid, (int*)out, n);
  return (int)cudaGetLastError();
}
