// Fused big-vocab cross-entropy: per-token NLL without resident logits.
//
// Replaces repro/kernels/cross_entropy.py::fused_ce_nd (the Pallas kernel: a
// (token blocks, vocab blocks) grid whose vocab axis runs in order on the
// TPU, an online log-sum-exp and the label logit in VMEM scratch).  For
// hidden (N, d), a head weight addressed as (V, d) through its strides (the
// tied embedding (V, d), or an untied (d, V) head read transposed, with no
// copy) and labels (N,):
//
//     nll_t = logsumexp_v(h_t · w_v) − h_t · w_{label_t},
//
// with f32 logits from the operands' dtype (float32 or bfloat16), the
// function repro_torch/kernels/ref.py::fused_ce_ref computes.
//
// Bound: 2·N·V·d operations against hidden, weight and labels read once and
// the NLL written once.  At (16384, 2048, 50280) in bf16 that is 3.37e12
// flops — 3.41 ms at the 989 TFLOP/s bf16 tensor-core peak, 50.4 ms at the
// 67 TFLOP/s f32 CUDA-core peak this kernel runs on — against 273 MB
// (0.08 ms): compute-bound.
//
// Design (simple and right first): a block of 128 threads owns a tile of 64
// tokens and walks the whole vocabulary in tiles of 128.  Each vocab tile is
// a register-tiled product on CUDA cores (8 × 8 logits a thread) over
// k-slices of 32 that are staged in shared memory as f32 (converted on
// load); then each row's running max and sum are updated online (shuffles
// over the 16 threads that share a row), and the thread whose column holds
// the label keeps that logit.  The logits never leave registers.  A ragged
// N, V or d is masked: rows past N load zeros and write nothing, columns
// past V are left out of the sums.  Tensor cores (mma.sync, then wgmma) are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kCeThreads = 128;  // an 8 × 16 thread grid
constexpr int kCeRows = 64;      // tokens a block
constexpr int kCeCols = 128;     // vocabulary entries a tile
constexpr int kCeK = 32;         // depth of a staged slice
constexpr float kCeNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kCeThreads)
fused_ce_kernel(const T* __restrict__ hidden, const T* __restrict__ weight,
                const int* __restrict__ labels, float* __restrict__ nll,
                int N, int V, int D, int64_t shn, int64_t swv, int64_t swd) {
  // hs[k][t] and ws[k][v], k-major; +1 keeps the transposed stores apart
  __shared__ float hs[kCeK][kCeRows + 1];
  __shared__ float ws[kCeK][kCeCols + 1];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // rows ty + 8i, columns tx + 16j
  const int t0 = blockIdx.x * kCeRows;

  int lab[8];
  float m[8], l[8], ll[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + ty + 8 * i;
    lab[i] = t < N ? labels[t] : -1;
    m[i] = kCeNegInf;
    l[i] = 0.0f;
    ll[i] = kCeNegInf;
  }

  for (int v0 = 0; v0 < V; v0 += kCeCols) {
    float acc[8][8] = {};
    for (int k0 = 0; k0 < D; k0 += kCeK) {
      // hidden slice: rows t0.., depth k0..; k fastest (rows are contiguous)
      for (int i = tid; i < kCeRows * kCeK; i += kCeThreads) {
        const int r = i / kCeK, k = i % kCeK;
        const int t = t0 + r, kk = k0 + k;
        hs[k][r] = (t < N && kk < D) ? to_f32(hidden[t * shn + kk]) : 0.0f;
      }
      // weight slice: along whichever of v and d is contiguous
      if (swd == 1) {
        for (int i = tid; i < kCeCols * kCeK; i += kCeThreads) {
          const int c = i / kCeK, k = i % kCeK;
          const int v = v0 + c, kk = k0 + k;
          ws[k][c] = (v < V && kk < D) ? to_f32(weight[v * swv + kk]) : 0.0f;
        }
      } else {
        for (int i = tid; i < kCeCols * kCeK; i += kCeThreads) {
          const int k = i / kCeCols, c = i % kCeCols;
          const int v = v0 + c, kk = k0 + k;
          ws[k][c] = (v < V && kk < D)
                         ? to_f32(weight[v * swv + (int64_t)kk * swd])
                         : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kCeK; ++k) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = hs[k][ty + 8 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // online log-sum-exp over this tile's columns, and the label logit
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float tmax = kCeNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = v0 + tx + 16 * j;
        if (v < V) {
          tmax = fmaxf(tmax, acc[i][j]);
          if (v == lab[i]) ll[i] = acc[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(m[i], tmax);
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (v0 + tx + 16 * j < V) s += expf(acc[i][j] - mnew);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      l[i] = l[i] * expf(m[i] - mnew) + s;
      m[i] = mnew;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lab_logit = ll[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lab_logit = fmaxf(lab_logit, __shfl_xor_sync(0xffffffffu, lab_logit, off));
    const int t = t0 + ty + 8 * i;
    if (tx == 0 && t < N)
      nll[t] = logf(fmaxf(l[i], 1e-30f)) + m[i] - lab_logit;
  }
}

}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (hidden and weight alike)
extern "C" int fused_ce_launch(const void* hidden, const void* weight,
                               const int* labels, float* nll, int N, int V,
                               int D, long long shn, long long swv,
                               long long swd, int dtype, void* stream) {
  using namespace repro_torch;
  if (N <= 0) return (int)cudaSuccess;
  if (V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCeRows - 1) / kCeRows);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    fused_ce_kernel<float><<<grid, kCeThreads, 0, s>>>(
        (const float*)hidden, (const float*)weight, labels, nll, N, V, D, shn,
        swv, swd);
  } else if (dtype == 1) {
    fused_ce_kernel<__nv_bfloat16><<<grid, kCeThreads, 0, s>>>(
        (const __nv_bfloat16*)hidden, (const __nv_bfloat16*)weight, labels,
        nll, N, V, D, shn, swv, swd);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
