// The end of a batched device-view get (kernels/ops.py::get_live_packed)
// for Hopper (sm_90a): everything after the seek's selector decode.
//
// Replaces no TPU kernel. The JAX package left these steps to XLA, which
// fuses them; the port ran them as ~150 eager PyTorch ops a partition
// (gathers, compares, clamps, a second selector_decode of the window's two
// groups), each a launch for a few hundred bytes of work, so the host's
// enqueue cost, not the card, bounded a get. This kernel does them in one
// launch and writes one packed int32 row a query, which the host fetches
// with one copy:
//   out[i] = found, run, row, then the VW value words of the slot.
//
// Inputs: query i's group g[i] (anchor_search) and the D slots of that
// group decoded (selector_decode with rows = g): runid, absidx, newest, pad.
// For each query, bit for bit as the composition it replaces:
//   1. the seek's in-group lower bound: s = the first slot whose key (at the
//      clamped (run, row); a placeholder is the +inf key) is >= the query in
//      unsigned word order, D if none, D if slot s is a placeholder;
//      pos = min(g*D + s, G*D);
//   2. the slot at pos: slot s of the decoded row if s < D, else slot 0 of
//      group h = min(g + 1, G - 1) (its decode needs no occurrence count):
//      pad = sel == 127, run = pad ? 0 : sel & 0x7F, newest = sel & 0x80,
//      row = run < RC ? cursors[h, run] : 0;
//   3. liveness at the clamped (run, row): dead = tomb | (exp != 0 &
//      exp <= now), unsigned; valid = newest & !pad & !dead & pos < G*D;
//      found = valid & key == query. run and row are written unclamped, the
//      values of the clamped slot for every query, found or not.
//
// Bound on the H100: latency, at the batches the store sends (a few hundred
// queries): four dependent loads a query (g, the decoded slot, its key, then
// the answer's slot and values). Bytes are small (the decoded row, D keys
// and one value a query). So:
//   - W lanes take one query (W the next power of two >= D, at most 32), a
//     warp 32 / W queries, as csrc/selector_decode.cu does; lane j compares
//     slot j's key, and the lower bound is one __ballot_sync and __ffs over
//     the query's lanes. With D > 32 a warp walks the row in chunks of 32
//     and stops at the first chunk that holds the bound.
//   - The answer's slot is then known to all W lanes, which copy its value
//     words together: one coalesced read of VW words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // per block
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int PLACEHOLDER = 127;

// key (KW words at k) >= query (at qw), unsigned and lexicographic
__device__ __forceinline__ bool key_ge(const uint32_t* __restrict__ k,
                                       const uint32_t* __restrict__ qw, int kw) {
  for (int w = 0; w < kw; ++w) {
    const uint32_t a = __ldg(k + w), b = __ldg(qw + w);
    if (a != b) return a > b;
  }
  return true;
}

__device__ __forceinline__ bool key_eq(const uint32_t* __restrict__ k,
                                       const uint32_t* __restrict__ qw, int kw) {
  bool eq = true;
  for (int w = 0; w < kw; ++w) eq &= __ldg(k + w) == __ldg(qw + w);
  return eq;
}

template <bool WIDE>
__global__ void __launch_bounds__(WARPS * 32)
get_resolve_kernel(const uint32_t* __restrict__ queries,
                   const int32_t* __restrict__ g,
                   const int32_t* __restrict__ runid,
                   const int32_t* __restrict__ absidx,
                   const bool* __restrict__ newest,
                   const bool* __restrict__ pad,
                   const uint32_t* __restrict__ keys,
                   const int32_t* __restrict__ vals,
                   const bool* __restrict__ tomb,
                   const uint32_t* __restrict__ exp,
                   const uint8_t* __restrict__ sel,
                   const int32_t* __restrict__ cursors,
                   int32_t* __restrict__ out,
                   int q, int d, int kw, int vw, int r, int nmax, int rc,
                   int groups, uint32_t now, int wshift) {
  const int lane = threadIdx.x & 31;
  const int w = 1 << wshift;  // lanes per query
  const int seg = lane >> wshift;  // query within the warp
  const int j0 = lane & (w - 1);
  const unsigned segmask = (w == 32 ? FULL : ((1u << w) - 1)) << (seg * w);
  const int i = (((blockIdx.x * WARPS) + (threadIdx.x >> 5)) << (5 - wshift)) + seg;
  const bool live = i < q;
  const uint32_t* qw = queries + (size_t)(live ? i : 0) * kw;
  const size_t row0 = (size_t)(live ? i : 0) * d;

  // 1. the in-group lower bound s (d when no slot qualifies)
  int s = d;
  bool s_pad = false;
  for (int base = 0; base < d; base += 32) {  // one pass unless WIDE
    const int j = base + j0;
    const bool active = live && j < d;
    bool ge = false, p = false;
    if (active) {
      p = pad[row0 + j];
      if (p) {
        ge = true;  // a placeholder is the +inf key
      } else {
        const int rr = min(max(__ldg(runid + row0 + j), 0), r - 1);
        const int ii = min(max(__ldg(absidx + row0 + j), 0), nmax - 1);
        ge = key_ge(keys + ((size_t)rr * nmax + ii) * kw, qw, kw);
      }
    }
    const unsigned geb = __ballot_sync(FULL, ge) & segmask;
    const unsigned padb = __ballot_sync(FULL, p) & segmask;
    if (geb) {
      const int first = __ffs(geb) - 1;  // a lane of this query's segment
      s = base + first - seg * w;
      s_pad = (padb >> first) & 1u;
    }
    if constexpr (!WIDE) break;
    if (geb) break;  // WIDE: one query a warp, so the whole warp leaves
  }
  if (s_pad) s = d;
  if (!live) return;

  // 2. the slot at pos
  const int gi = __ldg(g + i);
  const int pos_raw = gi * d + s;
  const bool in_view = pos_raw < groups * d;
  int run, row;
  bool nw, pd;
  if (s < d) {
    run = __ldg(runid + row0 + s);
    row = __ldg(absidx + row0 + s);
    nw = newest[row0 + s];
    pd = false;  // s is never a placeholder here
  } else {
    const int h = min(gi + 1, groups - 1);
    const int sv = sel[(size_t)h * d];
    pd = sv == PLACEHOLDER;
    run = pd ? 0 : (sv & 0x7F);
    nw = (sv & 0x80) != 0;
    row = run < rc ? __ldg(cursors + (size_t)h * rc + run) : 0;
  }

  // 3. liveness and the answer, at the clamped slot
  const size_t at = (size_t)min(max(run, 0), r - 1) * nmax + min(max(row, 0), nmax - 1);
  const uint32_t ex = __ldg(exp + at);
  const bool dead = tomb[at] || (ex != 0 && ex <= now);
  const bool valid = nw && !pd && !dead && in_view;
  int32_t* o = out + (size_t)i * (3 + vw);
  if (j0 == 0) {
    o[0] = valid && key_eq(keys + at * kw, qw, kw);
    o[1] = run;
    o[2] = row;
  }
  const int32_t* v = vals + at * vw;
  for (int k = j0; k < vw; k += w) o[3 + k] = __ldg(v + k);
}

}  // namespace

extern "C" int remix_get_resolve(const void* queries, const void* g, const void* runid,
                                 const void* absidx, const void* newest, const void* pad,
                                 const void* keys, const void* vals, const void* tomb,
                                 const void* exp, const void* selectors,
                                 const void* cursors, void* out, int q, int d, int kw,
                                 int vw, int r, int nmax, int rc, int groups,
                                 unsigned now, void* stream) {
  int wshift = 0;
  while ((1 << wshift) < d && wshift < 5) ++wshift;
  const long long per_block = (long long)WARPS << (5 - wshift);
  const int blocks = (int)((q + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REMIX_GET_RESOLVE_ARGS                                                     \
  static_cast<const uint32_t*>(queries), static_cast<const int32_t*>(g),           \
      static_cast<const int32_t*>(runid), static_cast<const int32_t*>(absidx),     \
      static_cast<const bool*>(newest), static_cast<const bool*>(pad),             \
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(vals),       \
      static_cast<const bool*>(tomb), static_cast<const uint32_t*>(exp),           \
      static_cast<const uint8_t*>(selectors), static_cast<const int32_t*>(cursors), \
      static_cast<int32_t*>(out), q, d, kw, vw, r, nmax, rc, groups, now, wshift
  if (d > 32) {
    get_resolve_kernel<true><<<blocks, WARPS * 32, 0, s>>>(REMIX_GET_RESOLVE_ARGS);
  } else {
    get_resolve_kernel<false><<<blocks, WARPS * 32, 0, s>>>(REMIX_GET_RESOLVE_ARGS);
  }
#undef REMIX_GET_RESOLVE_ARGS
  return static_cast<int>(cudaGetLastError());
}
