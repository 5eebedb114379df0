// In-group REMIX run-selector decode (paper §3.2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/selector_decode.py:
// selector_decode (body _decode_kernel). Output row i decodes row
// src = rows[i] (src = i when rows is null) of a (G, D) selector table,
// with the (G, R) cursor offsets at the group heads:
//   pad    = sel == 127
//   runid  = sel & 0x7F, 0 on pad
//   absidx = cursors[src, runid] + number of earlier non-pad slots of the
//            row with the same runid (0 on pad, so pad gives cursors[src, 0])
//   newest = sel & 0x80
// A runid >= R contributes no cursor and no count, as in the TPU kernel.
//
// Bound on the H100: bytes, mostly the 10 bytes written per slot (a row
// reads its id, D selector bytes and R cursor words). The TPU kernel
// unrolled a one-hot over R with a prefix sum along the lanes, and its
// caller first copied the groups into (Q, D) and (Q, R) tiles, because a
// BlockSpec cannot gather rows. Here:
//   - A warp decodes whole rows. With D = 32 lane j owns slot j; with a
//     smaller D the warp holds 32 / W rows of W lanes (W the next power of
//     two >= D); with D > 32 it walks the row in chunks of 32 slots, and a
//     per-warp count of each run in shared memory carries the earlier
//     chunks' occurrences into the next.
//   - The exclusive same-run count is __match_any_sync on a key of
//     (row within the warp, run or "not counted") and __popc of the peers
//     below the lane: no loop over earlier slots, no divergence.
//   - The lanes < R load the row's cursor words once, and each slot takes
//     its own with __shfl_sync (a runid >= W, possible only when R > W,
//     reads its word directly).
//   - The grid is indexed by rows, so no lane divides by D.
//   - The kernel reads the group tables through rows itself, so the path
//     runs no gather before it.
//   - When the rows outnumber the warps the card holds at once, each warp
//     takes RPW = 4 row groups and issues all their loads before it decodes
//     any, so four dependent chains (row id, then selectors and cursors)
//     overlap in each warp.
// Each warp store writes 32 neighbouring slots, so the stores coalesce.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // per block
constexpr int RESIDENT_WARPS_PER_SM = 64;  // 2,048 threads
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned NOT_COUNTED = 255;  // key part of a pad or runid >= R slot
constexpr int RUNS = 128;  // runid values (7 bits)

template <typename T, bool WIDE, int RPW>
__global__ void __launch_bounds__(WARPS * 32)
selector_decode_kernel(const T* __restrict__ sel,
                       const int32_t* __restrict__ cursors,
                       const int32_t* __restrict__ rows,
                       int32_t* __restrict__ runid_out,
                       int32_t* __restrict__ absidx_out,
                       bool* __restrict__ newest_out, bool* __restrict__ pad_out,
                       int n, int d, int r, int wshift) {
  // WIDE (D > 32): seen[run] = the run's slots in the row's earlier chunks
  __shared__ int seen_all[WIDE ? WARPS : 1][WIDE ? RUNS : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = 1 << wshift;  // lanes per row
  const int seg = lane >> wshift;  // row within the warp
  const int j0 = lane & (w - 1);
  const unsigned below = (1u << lane) - 1;
  int* seen = seen_all[WIDE ? warp : 0];
  // the lane's output row in row group u is i0 + u * (32 / W)
  const int i0 = ((blockIdx.x * WARPS + warp) * RPW << (5 - wshift)) + seg;

  int src[RPW];
  int32_t cur[RPW];
  int s0[RPW];  // the lane's selector in the first chunk (the only one unless WIDE)
#pragma unroll
  for (int u = 0; u < RPW; ++u) {
    const int i = i0 + (u << (5 - wshift));
    src[u] = i >= n ? 0 : rows ? __ldg(rows + i) : i;
  }
#pragma unroll
  for (int u = 0; u < RPW; ++u) {
    const bool live = i0 + (u << (5 - wshift)) < n;
    cur[u] = (live && j0 < r) ? __ldg(cursors + (size_t)src[u] * r + j0) : 0;
    s0[u] = (live && j0 < d) ? static_cast<int>(sel[(size_t)src[u] * d + j0]) : 127;
  }
#pragma unroll
  for (int u = 0; u < RPW; ++u) {
    const int i = i0 + (u << (5 - wshift));
    const bool live = i < n;
    if constexpr (WIDE) {
      for (int k = lane; k < RUNS; k += 32) seen[k] = 0;
      __syncwarp();
    }
    for (int base = 0; base < d; base += 32) {  // one pass unless WIDE
      const int j = base + j0;
      const bool active = live && j < d;
      const int s = base == 0 ? s0[u]
                    : active  ? static_cast<int>(sel[(size_t)src[u] * d + j])
                              : 127;
      const bool pad = s == 127;
      const int run = pad ? 0 : (s & 0x7F);
      const bool counted = !pad && run < r;
      const unsigned key =
          active ? (unsigned)seg << 8 | (counted ? (unsigned)run : NOT_COUNTED) : FULL;
      const unsigned peers = __match_any_sync(FULL, key);
      int occ = __popc(peers & below);
      if constexpr (WIDE) {
        if (counted) occ += seen[run];
        __syncwarp();
        if (counted && (peers & below) == 0) seen[run] += __popc(peers);
        __syncwarp();
      }
      const int32_t shared_word = __shfl_sync(FULL, cur[u], run, w);
      const int32_t c = run >= r ? 0
                        : run < w ? shared_word
                                  : __ldg(cursors + (size_t)src[u] * r + run);
      if (active) {
        const size_t o = (size_t)i * d + j;
        runid_out[o] = run;
        absidx_out[o] = c + (counted ? occ : 0);
        newest_out[o] = (s & 0x80) != 0;
        pad_out[o] = pad;
      }
      if constexpr (!WIDE) break;
    }
  }
}

template <typename T, bool WIDE, int RPW>
void launch_rows(const T* sel, const int32_t* c, const int32_t* rows, int32_t* ro,
                 int32_t* ao, bool* no, bool* po, int n, int d, int r,
                 int wshift, cudaStream_t s) {
  const long long rows_per_block = (long long)WARPS * RPW << (5 - wshift);
  const int blocks = (int)((n + rows_per_block - 1) / rows_per_block);
  selector_decode_kernel<T, WIDE, RPW><<<blocks, WARPS * 32, 0, s>>>(
      sel, c, rows, ro, ao, no, po, n, d, r, wshift);
}

template <typename T>
cudaError_t launch(const void* selectors, const int32_t* c, const int32_t* rows,
                   int32_t* ro, int32_t* ao, bool* no, bool* po, int n, int d,
                   int r, int sms, cudaStream_t s) {
  int wshift = 0;
  while ((1 << wshift) < d && wshift < 5) ++wshift;
  const T* sel = static_cast<const T*>(selectors);
  const long long warps = ((long long)n << wshift) / 32;  // at one row group each
  if (d > 32) {
    launch_rows<T, true, 1>(sel, c, rows, ro, ao, no, po, n, d, r, wshift, s);
  } else if (warps > (long long)RESIDENT_WARPS_PER_SM * sms) {
    launch_rows<T, false, 4>(sel, c, rows, ro, ao, no, po, n, d, r, wshift, s);
  } else {
    launch_rows<T, false, 1>(sel, c, rows, ro, ao, no, po, n, d, r, wshift, s);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int remix_selector_decode(const void* selectors, const void* cursors,
                                     const void* rows, void* runid, void* absidx,
                                     void* newest, void* pad, int n, int d,
                                     int r, int sel_u8, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(cursors);
  const int32_t* rw = static_cast<const int32_t*>(rows);
  int32_t* ro = static_cast<int32_t*>(runid);
  int32_t* ao = static_cast<int32_t*>(absidx);
  bool* no = static_cast<bool*>(newest);
  bool* po = static_cast<bool*>(pad);
  const cudaError_t e =
      sel_u8 ? launch<uint8_t>(selectors, c, rw, ro, ao, no, po, n, d, r, sms, s)
             : launch<int32_t>(selectors, c, rw, ro, ao, no, po, n, d, r, sms, s);
  return static_cast<int>(e);
}
