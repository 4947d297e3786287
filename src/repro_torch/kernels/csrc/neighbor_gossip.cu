// Neighbor-gather gossip epilogue for one packed variable, sparse W.
//
// Replaces repro/kernels/neighbor_gossip.py::sparse_gossip_nd (the Pallas
// kernel behind mixing_impl="sparse_packed").  W is given as padded-CSR
// neighbor lists: idx (n, m) int32 (padding = own row), w (n, m) f32
// (padding = 0.0) and the diagonal self_w (n,).  For row i:
//
//   WΔ_i = w_ii·Δ_i + Σ_{s<m} w_is·Δ_{idx_is}      (and Wθ_i alike)
//   θ'_i = Wθ_i + η_s·WΔ_i
//   c'_i = c_i + s·(Δ_i − WΔ_i)
//
// with scalar η_s and s.  Padding slots add exact zeros.  The diagonal is
// its own operand: no augmented (n, m+1) table is built.
//
// Bound: Δ, θ, c read once and θ', c' written once, plus the tables:
// 5·n·D·4 + n·(2m+1)·4 bytes against 4·n·(m+1)·D + 4·n·D flops — about
// 5 flop/byte at m ≈ 24, far below the card's ~20 f32 flop/byte, so the
// kernel is memory-bound.  Each Δ/θ row is gathered by about m+1 rows, so
// the kernel reaches the bound only if those re-reads hit L2.
//
// Design (simple and right first): a block owns kRows rows × kThreads
// columns; a thread owns one column of those rows and keeps 2·kRows f32
// accumulators in registers, so each gathered neighbor row is one coalesced
// 512-byte read per block.  The block's idx/w entries are staged in shared
// memory kSlots slots at a time (every thread reads the same entry: a
// broadcast), so any m fits.  The grid is 1-D with the row blocks of one
// D tile consecutive: the rows those blocks gather, a kThreads-column
// stripe of Δ and θ, stay in L2 while the tile is worked on.  The ragged D
// edge and the last row block are masked; n is not padded.  An index
// outside [0, n) is never dereferenced: that row's outputs become NaN.
//
// gossip_dtype = bfloat16 rounds w, w_ii, Δ and θ to bf16
// (__float2bfloat16_rn) and multiplies and adds in f32, where a bf16×bf16
// product is exact; only the order of the f32 sum differs from the plain
// version (repro_torch/kernels/ref.py::sparse_gossip_ref).  Δ stays f32 in
// the correction.
#include "epilogue.cuh"

namespace repro_torch {

constexpr int kNgThreads = 128;  // columns per block
constexpr int kNgRows = 4;       // rows per block
constexpr int kNgSlots = 32;     // neighbor slots staged per pass

template <bool BF16>
__global__ void __launch_bounds__(kNgThreads)
neighbor_gossip_kernel(const int* __restrict__ nidx,
                       const float* __restrict__ nw,
                       const float* __restrict__ self_w,
                       const float* __restrict__ delta,
                       const float* __restrict__ theta,
                       const float* __restrict__ c,
                       float* __restrict__ theta_out,
                       float* __restrict__ c_out, int n, int m, int64_t D,
                       unsigned row_blocks, float eta, float corr) {
  __shared__ int s_idx[kNgRows][kNgSlots];
  __shared__ float s_w[kNgRows][kNgSlots];
  const unsigned rb = blockIdx.x % row_blocks;
  const int64_t d =
      (int64_t)(blockIdx.x / row_blocks) * kNgThreads + threadIdx.x;
  const int i0 = (int)rb * kNgRows;
  const bool live = d < D;
  float acc_d[kNgRows], acc_t[kNgRows];
#pragma unroll
  for (int r = 0; r < kNgRows; ++r) {
    const int i = min(i0 + r, n - 1);
    const float sw = i0 + r < n ? narrow<BF16>(self_w[i]) : 0.f;
    const int64_t off = (int64_t)i * D + d;
    acc_d[r] = live ? sw * narrow<BF16>(delta[off]) : 0.f;
    acc_t[r] = live ? sw * narrow<BF16>(theta[off]) : 0.f;
  }
  for (int s0 = 0; s0 < m; s0 += kNgSlots) {
    for (int e = threadIdx.x; e < kNgRows * kNgSlots; e += kNgThreads) {
      const int r = e / kNgSlots, s = e % kNgSlots;
      const int i = i0 + r;
      const bool ok = i < n && s0 + s < m;
      const int64_t at = (int64_t)i * m + s0 + s;
      s_idx[r][s] = ok ? nidx[at] : 0;
      s_w[r][s] = ok ? narrow<BF16>(nw[at]) : 0.f;
    }
    __syncthreads();
    if (live) {
      const int sn = min(kNgSlots, m - s0);
      for (int s = 0; s < sn; ++s) {
#pragma unroll
        for (int r = 0; r < kNgRows; ++r) {
          const int j = s_idx[r][s];
          const float w = s_w[r][s];
          if ((unsigned)j < (unsigned)n) {
            const int64_t off = (int64_t)j * D + d;
            acc_d[r] = fmaf(w, narrow<BF16>(delta[off]), acc_d[r]);
            acc_t[r] = fmaf(w, narrow<BF16>(theta[off]), acc_t[r]);
          } else {
            acc_d[r] = acc_t[r] = __int_as_float(0x7fc00000);  // NaN
          }
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kNgRows; ++r) {
    const int i = i0 + r;
    if (i < n) {
      const int64_t off = (int64_t)i * D + d;
      theta_out[off] = acc_t[r] + eta * acc_d[r];
      c_out[off] = c[off] + corr * (delta[off] - acc_d[r]);
    }
  }
}

}  // namespace repro_torch

extern "C" int sparse_gossip_launch(const int* nidx, const float* nw,
                                    const float* self_w, const float* delta,
                                    const float* theta, const float* c,
                                    float* theta_out, float* c_out, int n,
                                    int m, long long D, float eta_s,
                                    float corr_scale, int bf16,
                                    void* stream) {
  using namespace repro_torch;
  if (n <= 0 || D <= 0) return (int)cudaSuccess;
  const unsigned long long row_blocks = (n + kNgRows - 1) / kNgRows;
  const unsigned long long col_tiles = (D + kNgThreads - 1) / kNgThreads;
  if (row_blocks * col_tiles > 0x7fffffffULL)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(row_blocks * col_tiles));
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    neighbor_gossip_kernel<true><<<grid, kNgThreads, 0, st>>>(
        nidx, nw, self_w, delta, theta, c, theta_out, c_out, n, m,
        (int64_t)D, (unsigned)row_blocks, eta_s, corr_scale);
  else
    neighbor_gossip_kernel<false><<<grid, kNgThreads, 0, st>>>(
        nidx, nw, self_w, delta, theta, c, theta_out, c_out, n, m,
        (int64_t)D, (unsigned)row_blocks, eta_s, corr_scale);
  return (int)cudaGetLastError();
}
