// Batched REMIX anchor search (paper §3.1 step 1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/anchor_search.py:
// anchor_le_count (body _le_count_kernel) and the two-level composition
// anchor_search around it. For each query of KW uint32 words (word 0 most
// significant) it returns upper_bound(anchors, query): the number of
// anchors <= query, which equals the Pallas compare-and-count for sorted
// anchors (its contract). With minus_one set it returns
// max(upper_bound - 1, 0), the query's target group.
//
// Bound on the H100: latency. A search needs only a few KB of L2-resident
// anchor rows, but one thread's binary search over the (G, KW) rows waits
// on about log2(G) dependent loads (15 at G = 32,768), the lower ones L2
// round trips. The TPU kernel instead compared every anchor with every
// query, O(G) per query, with a coarse level in front to bound that work.
// This kernel cuts the dependent round trips in one of two ways, chosen by
// the number of queries per SM:
//   - Few queries (Q < SAMPLE_MIN_QUERIES_PER_SM x SMs; the 256-key gets
//     and the scans): a warp per query runs a 32-ary search in device
//     memory. Each step, lane j reads the j-th of 32 evenly spaced pivot
//     rows, and a ballot counts the pivots <= query, which picks the next
//     interval. log32(G) steps (3 at G = 32,768), each one round trip; the
//     first steps' pivots are shared by every query and stay in L1.
//   - Many queries (the 65,536-key gets): each block stages a sample,
//     every stride-th anchor row, into shared memory with cp.async, and a
//     thread per query binary-searches it there. The query then finishes
//     inside its stride-row block in device memory: at most 4 dependent
//     steps when the block is one 128-byte line (stride = 32 / KW rows,
//     wherever that sample fits in SAMPLE_BYTES_MAX; the wrapper's _plan
//     doubles the stride for larger G). One block per SM serves its
//     queries in a grid-stride loop, so a block stages the sample once for
//     hundreds of queries: staging thousands of scattered rows costs a
//     block more than a few queries' searches, and pays off only at that
//     scale.
// No sampled copy of the anchors is kept between launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARP_THREADS = 256;  // per block, warp-per-query search
constexpr int SAMPLE_THREADS = 512;  // per block, sampled search
// kernels/anchor_search.py holds the same two values
constexpr int SAMPLE_MIN_QUERIES_PER_SM = 128;
constexpr int SAMPLE_BYTES_MAX = 48 * 1024;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// lexicographic row <= key, word 0 most significant; branch-free so that
// the loads of a row issue together
template <int KW>
__device__ __forceinline__ bool le(const uint32_t* row, const uint32_t (&key)[KW]) {
  uint32_t a[KW];
#pragma unroll
  for (int w = 0; w < KW; ++w) a[w] = row[w];
  bool r = true;
#pragma unroll
  for (int w = KW - 1; w >= 0; --w) r = a[w] < key[w] || (a[w] == key[w] && r);
  return r;
}

template <int KW>
__device__ __forceinline__ void load_key(uint32_t (&key)[KW], const uint32_t* p) {
#pragma unroll
  for (int w = 0; w < KW; ++w) key[w] = __ldg(p + w);
}

__device__ __forceinline__ int32_t result(int ub, int minus_one) {
  return minus_one ? max(ub - 1, 0) : ub;
}

// One warp per query: the answer lies in [lo, lo + n]; 32 pivots split the
// interval into 33 parts, and the pivots <= query (a prefix) pick one.
template <int KW>
__global__ void __launch_bounds__(WARP_THREADS)
warp_search_kernel(const uint32_t* __restrict__ anchors,
                   const uint32_t* __restrict__ queries,
                   int32_t* __restrict__ out, int g, int q, int minus_one) {
  const int lane = threadIdx.x & 31;
  const int i = (blockIdx.x * WARP_THREADS + threadIdx.x) >> 5;
  if (i >= q) return;  // whole warps leave together
  uint32_t key[KW];
  load_key(key, queries + (size_t)i * KW);
  int lo = 0;
  int n = g;
  while (n > 32) {
    const int step = (n + 32) / 33;
    const int row = lo + (lane + 1) * step - 1;
    const bool go = row < lo + n && le(anchors + (size_t)row * KW, key);
    const int c = __popc(__ballot_sync(FULL, go));
    const int hi = c == 32 ? lo + n : min(lo + n, lo + (c + 1) * step - 1);
    lo += c * step;
    n = hi - lo;
  }
  const bool go = lane < n && le(anchors + (size_t)(lo + lane) * KW, key);
  const int c = __popc(__ballot_sync(FULL, go));
  if (lane == 0) out[i] = result(lo + c, minus_one);
}

// A thread per query over a shared-memory sample of every stride-th row.
template <int KW>
__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_search_kernel(const uint32_t* __restrict__ anchors,
                     const uint32_t* __restrict__ queries,
                     int32_t* __restrict__ out, int g, int q, int stride,
                     int n_sample, int minus_one) {
  extern __shared__ uint32_t sample[];  // row k = anchor row k * stride
  for (int t = threadIdx.x; t < n_sample * KW; t += SAMPLE_THREADS) {
    const int k = t / KW;
    cp_async4(sample + t, anchors + (size_t)k * stride * KW + (t - k * KW));
  }
  const int step = gridDim.x * SAMPLE_THREADS;
  int i = blockIdx.x * SAMPLE_THREADS + threadIdx.x;
  uint32_t key[KW];
  if (i < q) load_key(key, queries + (size_t)i * KW);  // while the sample lands
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  while (i < q) {
    // upper_bound over the sample: lo = sample rows <= key
    int lo = 0;
    int n = n_sample;
    while (n > 0) {
      const int half = n >> 1;
      const bool go = le(sample + (lo + half) * KW, key);
      lo = go ? lo + half + 1 : lo;
      n = go ? n - half - 1 : half;
    }
    int ub = 0;
    if (lo > 0) {
      // row (lo - 1) * stride is <= key; search the rest of its block
      ub = (lo - 1) * stride + 1;
      n = (int)min((long long)lo * stride, (long long)g) - ub;
      while (n > 0) {
        const int half = n >> 1;
        const bool go = le(anchors + (size_t)(ub + half) * KW, key);
        ub = go ? ub + half + 1 : ub;
        n = go ? n - half - 1 : half;
      }
    }
    out[i] = result(ub, minus_one);
    i += step;
    if (i < q) load_key(key, queries + (size_t)i * KW);
  }
}

template <int KW>
cudaError_t launch(const void* anchors, const void* queries, void* out, int g,
                   int q, int stride, int sms, int minus_one, cudaStream_t s) {
  const uint32_t* a = static_cast<const uint32_t*>(anchors);
  const uint32_t* k = static_cast<const uint32_t*>(queries);
  int32_t* o = static_cast<int32_t*>(out);
  if (q < SAMPLE_MIN_QUERIES_PER_SM * sms) {
    const int blocks = (int)(((long long)q * 32 + WARP_THREADS - 1) / WARP_THREADS);
    warp_search_kernel<KW><<<blocks, WARP_THREADS, 0, s>>>(a, k, o, g, q, minus_one);
    return cudaGetLastError();
  }
  if (stride < 1) return cudaErrorInvalidValue;
  const int n_sample = (g + stride - 1) / stride;
  if ((long long)n_sample * KW * 4 > SAMPLE_BYTES_MAX) return cudaErrorInvalidValue;
  const int blocks = std::min((q + SAMPLE_THREADS - 1) / SAMPLE_THREADS, sms);
  sample_search_kernel<KW><<<blocks, SAMPLE_THREADS, n_sample * KW * 4, s>>>(
      a, k, o, g, q, stride, n_sample, minus_one);
  return cudaGetLastError();
}

}  // namespace

extern "C" int remix_anchor_search(const void* anchors, const void* queries,
                                   void* out, int g, int q, int kw, int stride,
                                   int sms, int minus_one, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1:
      return static_cast<int>(launch<1>(anchors, queries, out, g, q, stride, sms, minus_one, s));
    case 2:
      return static_cast<int>(launch<2>(anchors, queries, out, g, q, stride, sms, minus_one, s));
    case 3:
      return static_cast<int>(launch<3>(anchors, queries, out, g, q, stride, sms, minus_one, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
