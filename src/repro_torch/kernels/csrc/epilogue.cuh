// The packed gossip epilogue, shared by both round kernels.
//
//   WΔ = W Δ,  Wθ = W θ
//   θ' = Wθ + η ⊙ WΔ
//   c' = c + s ⊙ (Δ − WΔ)
//
// gossip.cu instantiates it with scalar η, s (one variable's epilogue,
// replacing repro/kernels/gossip.py::fused_gossip_nd), over a block of
// n_out rows of W (n_out, n) whose out row r reads Δ[row0 + r] in its
// correction (launch_gossip_epilogue_rows); fused_round.cu with
// per-(row, column) η, s arrays (the epilogue of the whole round, where the
// x and y blocks of z carry different stepsizes and signs, with Δ → q and
// θ → z0).
//
// Bound: Δ, θ, c are read once and θ', c' written once (5·n·D·4 bytes)
// against 4·n²·D flops, so for the client counts of the main path (n ≤ a
// few dozen) the epilogue is memory-bound (n = 8: 1.6 flop/byte, far below
// the card's ~20 f32 flop/byte).  Design: a thread owns one column d of a
// TI-row output tile and keeps its TI accumulators for WΔ and Wθ in
// registers; neighbouring threads hold neighbouring columns, so every load
// and store of a warp is one coalesced 128-byte line.  W is staged through
// shared memory in TI × 32 tiles (every thread of the block reads the same
// W entry: a broadcast).  For n ≤ TI each Δ/θ element comes from device
// memory once (its second read, for the correction, hits the cache); larger
// n re-reads Δ and θ once per TI-row tile, mostly from L2.  The ragged D
// edge is masked in the kernel: no padding copies.
//
// gossip_dtype = bfloat16 rounds W, Δ, θ to bf16 (__float2bfloat16_rn) and
// multiplies and adds in f32; a product of two bf16 values is exact in f32,
// so only the order of the f32 sum differs from the reference.  Δ stays f32
// in the correction.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kEpiThreads = 128;  // columns per block
constexpr int kEpiTJ = 32;        // W columns per shared-memory tile

__device__ __forceinline__ float narrow_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float narrow(float v) {
  return BF16 ? narrow_bf16(v) : v;
}

// One η and one s for the whole (n, D) buffer.
struct ScalarScales {
  float eta, corr;
  __device__ float eta_at(int64_t) const { return eta; }
  __device__ float corr_at(int64_t) const { return corr; }
};

// Per-element η and s, laid out like the (n, D) state.
struct ArrayScales {
  const float* __restrict__ eta;
  const float* __restrict__ corr;
  __device__ float eta_at(int64_t off) const { return eta[off]; }
  __device__ float corr_at(int64_t off) const { return corr[off]; }
};

// grid = (ceil(D / kEpiThreads), ceil(n_out / TI)); block = kEpiThreads.
// W is (n_out, n), Δ and θ (n, D), c and the outputs (n_out, D).
template <int TI, bool BF16, class Scales>
__global__ void __launch_bounds__(kEpiThreads)
gossip_epilogue_kernel(const float* __restrict__ w,
                       const float* __restrict__ delta,
                       const float* __restrict__ theta,
                       const float* __restrict__ c,
                       float* __restrict__ theta_out,
                       float* __restrict__ c_out,
                       int n, int n_out, int row0, int64_t D, Scales sc) {
  __shared__ float ws[TI][kEpiTJ];
  const int64_t d = (int64_t)blockIdx.x * kEpiThreads + threadIdx.x;
  const int i0 = blockIdx.y * TI;
  const bool live = d < D;
  float acc_d[TI], acc_t[TI];
#pragma unroll
  for (int ii = 0; ii < TI; ++ii) {
    acc_d[ii] = 0.f;
    acc_t[ii] = 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += kEpiTJ) {
    for (int e = threadIdx.x; e < TI * kEpiTJ; e += kEpiThreads) {
      const int i = i0 + e / kEpiTJ, j = j0 + e % kEpiTJ;
      ws[e / kEpiTJ][e % kEpiTJ] =
          (i < n_out && j < n) ? narrow<BF16>(w[(int64_t)i * n + j]) : 0.f;
    }
    __syncthreads();
    if (live) {
      const int jn = min(kEpiTJ, n - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const int64_t off = (int64_t)(j0 + jj) * D + d;
        const float dv = narrow<BF16>(delta[off]);
        const float tv = narrow<BF16>(theta[off]);
#pragma unroll
        for (int ii = 0; ii < TI; ++ii) {
          acc_d[ii] = fmaf(ws[ii][jj], dv, acc_d[ii]);
          acc_t[ii] = fmaf(ws[ii][jj], tv, acc_t[ii]);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int ii = 0; ii < TI; ++ii) {
    const int i = i0 + ii;
    if (i < n_out) {
      const int64_t off = (int64_t)i * D + d;
      const float own = delta[(int64_t)(row0 + i) * D + d];
      theta_out[off] = acc_t[ii] + sc.eta_at(off) * acc_d[ii];
      c_out[off] = c[off] + sc.corr_at(off) * (own - acc_d[ii]);
    }
  }
}

// Launches the epilogue of out rows [row0, row0 + n_out) on `stream`;
// returns cudaGetLastError().  The tile height follows n_out.
template <class Scales>
cudaError_t launch_gossip_epilogue_rows(const float* w, const float* delta,
                                        const float* theta, const float* c,
                                        float* theta_out, float* c_out, int n,
                                        int n_out, int row0, int64_t D,
                                        bool bf16, Scales sc,
                                        cudaStream_t stream) {
  if (n <= 0 || n_out <= 0 || D <= 0) return cudaSuccess;
  const unsigned gx = (unsigned)((D + kEpiThreads - 1) / kEpiThreads);
  if (n_out <= 8) {
    const dim3 grid(gx, 1);
    if (bf16)
      gossip_epilogue_kernel<8, true, Scales><<<grid, kEpiThreads, 0, stream>>>(
          w, delta, theta, c, theta_out, c_out, n, n_out, row0, D, sc);
    else
      gossip_epilogue_kernel<8, false, Scales><<<grid, kEpiThreads, 0, stream>>>(
          w, delta, theta, c, theta_out, c_out, n, n_out, row0, D, sc);
  } else {
    const dim3 grid(gx, (unsigned)((n_out + 31) / 32));
    if (bf16)
      gossip_epilogue_kernel<32, true, Scales><<<grid, kEpiThreads, 0, stream>>>(
          w, delta, theta, c, theta_out, c_out, n, n_out, row0, D, sc);
    else
      gossip_epilogue_kernel<32, false, Scales><<<grid, kEpiThreads, 0, stream>>>(
          w, delta, theta, c, theta_out, c_out, n, n_out, row0, D, sc);
  }
  return cudaGetLastError();
}

// The epilogue of all of W (n, n): every row, row0 = 0.
template <class Scales>
cudaError_t launch_gossip_epilogue(const float* w, const float* delta,
                                   const float* theta, const float* c,
                                   float* theta_out, float* c_out, int n,
                                   int64_t D, bool bf16, Scales sc,
                                   cudaStream_t stream) {
  return launch_gossip_epilogue_rows(w, delta, theta, c, theta_out, c_out, n,
                                     n, 0, D, bf16, sc, stream);
}

}  // namespace repro_torch
