// RG-LRU linear recurrence  h_t = a_t · h_{t−1} + u_t  over (B, S, W) f32.
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan_b (the Pallas kernel: a
// chunked doubling scan with the carry in VMEM).  The recurrence starts from
// h_{−1} = 0; a caller with a carried state h0 folds it into the first step
// (u_0 ← u_0 + a_0·h0) before the launch, as the Pallas kernel folds its
// carry into each chunk's first row.
//
// Bound: a and u read once, h written once: 12·B·S·W bytes against 2·B·S·W
// flops (0.17 flop/byte), so the kernel is memory-bound.  At the served
// shape (B, S, W) = (4, 4096, 4096) that is 805 MB, 0.24 ms at 3.35 TB/s.
//
// Design (simple and right first): one thread per (b, w) channel walks S in
// order and keeps h in a register; neighbouring threads hold neighbouring w,
// so each step's loads and store are coalesced 128-byte lines.  The loads of
// a_t and u_t do not depend on h, so they are issued kUnroll steps ahead:
// the next kUnroll steps are loaded into registers while the current
// kUnroll steps are computed.  The ragged W edge is masked and any S is
// taken (steps past S load the identity a = 1, u = 0 and store nothing).
// Each step rounds the product and the sum separately (no fused
// multiply-add), the order of the plain version
// (repro_torch/kernels/ref.py::rglru_ref), so the two agree bit for bit.
//
// A time-parallel two-pass scan (per-chunk (Πa, h) summaries, then a pass
// that applies the carried prefix) would give B·W·S/chunk threads instead of
// B·W; at B·W = 16384 channels one pass fills 128 blocks of 128 threads, one
// per SM, which this simple kernel accepts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kScanThreads = 128;  // channels per block
constexpr int kUnroll = 16;        // steps loaded ahead

__global__ void __launch_bounds__(kScanThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ u,
                  float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kScanThreads + threadIdx.x;
  if (w >= W) return;
  const int64_t base = (int64_t)blockIdx.y * S * W + w;
  const float* ap = a + base;
  const float* up = u + base;
  float* hp = h + base;

  float ca[kUnroll], cu[kUnroll], na[kUnroll], nu[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const bool in = i < S;
    ca[i] = in ? __ldcs(ap + (int64_t)i * W) : 1.0f;
    cu[i] = in ? __ldcs(up + (int64_t)i * W) : 0.0f;
  }
  float hv = 0.0f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 + kUnroll + i;
      const bool in = t < S;
      na[i] = in ? __ldcs(ap + (int64_t)t * W) : 1.0f;
      nu[i] = in ? __ldcs(up + (int64_t)t * W) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      hv = __fadd_rn(__fmul_rn(ca[i], hv), cu[i]);
      if (t0 + i < S) __stcs(hp + (int64_t)(t0 + i) * W, hv);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ca[i] = na[i];
      cu[i] = nu[i];
    }
  }
}

}  // namespace repro_torch

extern "C" int rglru_scan_launch(const float* a, const float* u, float* h,
                                 int B, int S, int W, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((W + kScanThreads - 1) / kScanThreads, B);
  rglru_scan_kernel<<<grid, kScanThreads, 0, (cudaStream_t)stream>>>(
      a, u, h, S, W);
  return (int)cudaGetLastError();
}
