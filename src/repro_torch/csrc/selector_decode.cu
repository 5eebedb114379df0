// In-group REMIX run-selector decode (paper §3.2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/selector_decode.py:
// selector_decode (body _decode_kernel). Per slot of a (Q, D) selector tile
// with (Q, R) cursor offsets at the group heads:
//   pad    = sel == 127
//   runid  = sel & 0x7F, 0 on pad
//   absidx = cursors[row, runid] + number of earlier non-pad slots of the
//            row with the same runid (0 on pad, so pad gives cursors[row, 0])
//   newest = sel & 0x80
// A runid >= R contributes no cursor and no count, as in the TPU kernel.
//
// Bound on the H100: bytes. Each slot reads one selector byte and one cursor
// word and writes 10 bytes (runid, absidx, newest, pad); the count is at most
// 63 compares over bytes of the same row, which the L1 serves. The TPU kernel
// unrolled a one-hot over R and a prefix sum along the lane axis; here one
// thread per (row, slot) counts its own row directly, so the work does not
// grow with R and the selectors are read as uint8 with no widening pass.
// Neighbouring threads write neighbouring slots, so the stores coalesce.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void selector_decode_kernel(const T* __restrict__ sel,
                                       const int32_t* __restrict__ cursors,
                                       int32_t* __restrict__ runid_out,
                                       int32_t* __restrict__ absidx_out,
                                       bool* __restrict__ newest_out,
                                       bool* __restrict__ pad_out, int q,
                                       int d, int r) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)q * d) return;
  const int row = (int)(idx / d);
  const int j = (int)(idx - (long long)row * d);
  const T* srow = sel + (size_t)row * d;
  const int s = (int)srow[j];
  const bool pad = s == 127;
  const int run = pad ? 0 : (s & 0x7F);
  const bool counted = !pad && run < r;
  int occ = 0;
  if (counted) {
    for (int k = 0; k < j; ++k) {
      const int sk = (int)srow[k];
      occ += (sk != 127 && (sk & 0x7F) == run) ? 1 : 0;
    }
  }
  const int base = run < r ? cursors[(size_t)row * r + run] : 0;
  runid_out[idx] = run;
  absidx_out[idx] = base + occ;
  newest_out[idx] = (s & 0x80) != 0;
  pad_out[idx] = pad;
}

}  // namespace

extern "C" int remix_selector_decode(const void* selectors, const void* cursors,
                                     void* runid, void* absidx, void* newest,
                                     void* pad, int q, int d, int r,
                                     int sel_u8, void* stream) {
  const int threads = 256;
  const long long total = (long long)q * d;
  const int blocks = (int)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(cursors);
  int32_t* ro = static_cast<int32_t*>(runid);
  int32_t* ao = static_cast<int32_t*>(absidx);
  bool* no = static_cast<bool*>(newest);
  bool* po = static_cast<bool*>(pad);
  if (sel_u8) {
    selector_decode_kernel<uint8_t><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(selectors), c, ro, ao, no, po, q, d, r);
  } else {
    selector_decode_kernel<int32_t><<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(selectors), c, ro, ao, no, po, q, d, r);
  }
  return static_cast<int>(cudaGetLastError());
}
