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
// Bound on the H100: bytes, and latency more than bandwidth. The TPU kernel
// streamed every anchor tile past every query tile (O(G) compares per query,
// shaped for the vector unit). Here one thread per query runs a binary search
// over the (G, KW) anchor rows: about log2(G) dependent loads per query, and
// no pass over the whole array. A partition's anchors (tens to hundreds of
// KB) stay in the 50 MB L2 after the first batch, so each probe is an L2 hit
// and the kernel's time is log2(G) L2 round trips plus the launch. The one
// kernel owns both levels of the TPU design: a binary search has no need of
// the coarse level that bounded the compare-and-count's O(G) work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int KW>
__global__ void anchor_search_kernel(const uint32_t* __restrict__ anchors,
                                     const uint32_t* __restrict__ queries,
                                     int32_t* __restrict__ out, int g, int q,
                                     int minus_one) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  uint32_t key[KW];
#pragma unroll
  for (int w = 0; w < KW; ++w) key[w] = queries[(size_t)i * KW + w];

  // upper_bound: lo = first row whose key is > query. The loop keeps
  // [lo, lo + n) as the rows not yet decided; each step halves it.
  int lo = 0;
  int n = g;
  while (n > 0) {
    const int half = n >> 1;
    const uint32_t* a = anchors + (size_t)(lo + half) * KW;
    // lexicographic a <= key, word 0 most significant
    bool le = true;
    bool decided = false;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const uint32_t x = __ldg(a + w);
      if (!decided && x != key[w]) {
        le = x < key[w];
        decided = true;
      }
    }
    lo = le ? lo + half + 1 : lo;
    n = le ? n - half - 1 : half;
  }
  out[i] = minus_one ? (lo > 0 ? lo - 1 : 0) : lo;
}

}  // namespace

extern "C" int remix_anchor_search(const void* anchors, const void* queries,
                                   void* out, int g, int q, int kw,
                                   int minus_one, void* stream) {
  const int threads = 256;
  const int blocks = (q + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(anchors);
  const uint32_t* k = static_cast<const uint32_t*>(queries);
  int32_t* o = static_cast<int32_t*>(out);
  switch (kw) {
    case 1:
      anchor_search_kernel<1><<<blocks, threads, 0, s>>>(a, k, o, g, q, minus_one);
      break;
    case 2:
      anchor_search_kernel<2><<<blocks, threads, 0, s>>>(a, k, o, g, q, minus_one);
      break;
    case 3:
      anchor_search_kernel<3><<<blocks, threads, 0, s>>>(a, k, o, g, q, minus_one);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
