// Mamba2 SSD chunked scan over the model layout, f32.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan_bh (the Pallas kernel: a
// (batch·heads, chunks) grid whose chunk axis runs in order on the TPU, the
// (P, N) state in VMEM scratch).  It computes what
// repro_torch/models/ssm.py::ssd_chunked computes (its plain version, in
// repro_torch/kernels/ref.py): for one head with state S ∈ R^{P×N},
//
//     S_t = exp(loga_t)·S_{t−1} + xdt_t ⊗ B_t,        y_t = S_t · C_t,
//
// evaluated chunk by chunk: with cum the inclusive prefix sum of loga over
// the chunk,
//
//     scores[t][u] = exp(cum_t − cum_u)·(C_t · B_u)   for u ≤ t (else 0)
//     y            = scores·xdt + exp(cum)·(C·Sᵀ)
//     S            ← exp(cum_L)·S + Σ_u exp(cum_L − cum_u)·xdt_u ⊗ B_u.
//
// Unlike the Pallas kernel it starts from an optional state0 and writes the
// final state: the model's function does both, and decode needs the
// prefill's final state.
//
// Bound: xdt and y (B·S·H·P each), loga (B·S·H), B and C (B·S·N each) and
// the states are moved once; per (chunk, head) the chunked form does
// L(L+1)/2·P + 2·L·P·N multiply-adds, and C·Bᵀ (L(L+1)/2·N) once per
// (batch row, chunk).  At (8, 4096, 64, 64, 128) that is 1.10 GB (0.33 ms
// at 3.35 TB/s) against 7.8e10 flops (1.16 ms at the 67 TFLOP/s f32
// CUDA-core peak): compute-bound on CUDA cores.
//
// Design (simple and right first): one block of 256 threads per (b, h)
// walks its chunks in order; the (P, N) state stays in shared memory across
// chunks.  Each chunk stages its xdt (L×P), B and C (L×N) tiles, takes the
// prefix sum of loga with warp shuffles, forms the scores only for u ≤ t
// (exp(cum_t − cum_u) for u > t would be +inf, and inf·0 is NaN, so it is
// never formed), then computes y and the next state as register-tiled
// products (4×4 and 4×8 outputs a thread) out of shared memory.  Row
// strides of N + 1 and L + 1 keep the column reads of the products free of
// bank conflicts.  The operands are read through their strides (the last
// dimension contiguous), so the model's (B, S, H, P) layout needs no
// transpose; a ragged last chunk is masked by zero-filling the tile rows
// past S (the reference pads the same zeros) and writing no y for them.
// C·Bᵀ is the same for all heads of a batch row and is recomputed per head,
// and at batch 1 only H blocks run: both are left for later speed work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kSsdThreads = 256;  // a 16 × 16 thread grid
constexpr int kMaxChunk = 64;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

__device__ __forceinline__ int clampi(int v, int hi) { return v < hi ? v : hi; }

__global__ void __launch_bounds__(kSsdThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ loga,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ state0, float* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N,
                int L, int64_t sxb, int64_t sxs, int64_t sxh, int64_t slb,
                int64_t sls, int64_t slh, int64_t sbb, int64_t sbs,
                int64_t scb, int64_t scs) {
  extern __shared__ float smem[];
  const int NS = N + 1;  // row stride of bs, cs, st
  const int LS = L + 1;  // row stride of sc
  float* xs = smem;                 // [L][P]
  float* bs = xs + L * P;           // [L][NS]
  float* cs = bs + L * NS;          // [L][NS]
  float* st = cs + L * NS;          // [P][NS] the carried state
  float* sc = st + P * NS;          // [L][LS] the scores
  float* cum = sc + L * LS;         // [L] inclusive prefix sum of loga
  float* ecum = cum + L;            // [L] exp(cum_t)
  float* dec = ecum + L;            // [L] exp(cum_L − cum_u)

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  const float* xb = xdt + b * sxb + h * sxh;
  const float* lb = loga + b * slb + h * slh;
  const float* bb = bm + b * sbb;
  const float* cb = cm + b * scb;
  float* yb = y + ((int64_t)b * S * H + h) * P;  // y is (B, S, H, P)

  const int64_t sidx = ((int64_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kSsdThreads) {
    const int p = i / N, n = i % N;
    st[p * NS + n] = state0 ? state0[sidx + i] : 0.0f;
  }

  const int nchunks = (S + L - 1) / L;
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * L;
    const int lc = clampi(L, S - s0);  // valid rows of this chunk

    // 1. stage the tiles; rows past S are zeros, as the reference pads
    for (int i = tid; i < L * P; i += kSsdThreads) {
      const int t = i / P, p = i % P;
      xs[i] = t < lc ? xb[(s0 + t) * sxs + p] : 0.0f;
    }
    for (int i = tid; i < L * N; i += kSsdThreads) {
      const int t = i / N, n = i % N;
      const bool in = t < lc;
      bs[t * NS + n] = in ? bb[(s0 + t) * sbs + n] : 0.0f;
      cs[t * NS + n] = in ? cb[(s0 + t) * scs + n] : 0.0f;
    }
    if (tid < L) cum[tid] = tid < lc ? lb[(s0 + tid) * sls] : 0.0f;
    __syncthreads();

    // 2. inclusive prefix sum of loga (L ≤ 64: two entries a lane of warp 0)
    if (tid < 32) {
      const int i0 = 2 * tid, i1 = 2 * tid + 1;
      const float v0 = i0 < L ? cum[i0] : 0.0f;
      const float v1 = i1 < L ? cum[i1] : 0.0f;
      const float pair = v0 + v1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - pair;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      if (i0 < L) {
        cum[i0] = excl + v0;
        ecum[i0] = expf(excl + v0);
        dec[i0] = expf(last - (excl + v0));
      }
      if (i1 < L) {
        cum[i1] = incl;
        ecum[i1] = expf(incl);
        dec[i1] = expf(last - incl);
      }
    }
    __syncthreads();
    const float cum_last = cum[L - 1];

    // 3. scores[t][u] for t = ty + 16i, u = tx + 16j: C_t·B_u, then the
    // decay for u ≤ t only
    {
      float acc[4][4] = {};
      int tr[4], ur[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tr[i] = clampi(ty + 16 * i, L - 1);
        ur[i] = clampi(tx + 16 * i, L - 1);
      }
      for (int n = 0; n < N; ++n) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = cs[tr[i] * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[ur[j] * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = tx + 16 * j;
          if (u >= L) continue;
          sc[t * LS + u] = u <= t ? expf(cum[t] - cum[u]) * acc[i][j] : 0.0f;
        }
      }
    }
    __syncthreads();

    // 4. y[t][p] for t = ty + 16i, p = tx + 16j:
    //    exp(cum_t)·(C_t · S_p) + Σ_{u ≤ t} scores[t][u]·xdt[u][p]
    {
      float inter[4][4] = {};
      float intra[4][4] = {};
      int tr[4], pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tr[i] = clampi(ty + 16 * i, L - 1);
        pr[i] = clampi(tx + 16 * i, P - 1);
      }
      for (int n = 0; n < N; ++n) {
        float a[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = cs[tr[i] * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = st[pr[j] * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            inter[i][j] = fmaf(a[i], sv[j], inter[i][j]);
      }
      for (int u = 0; u < L; ++u) {
        float a[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sc[tr[i] * LS + u];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[u * P + pr[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            intra[i][j] = fmaf(a[i], xv[j], intra[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= lc) continue;
        const float e = ecum[t];
        float* yrow = yb + (int64_t)(s0 + t) * H * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yrow[p] = intra[i][j] + e * inter[i][j];
        }
      }
    }

    // 5. the next state, S[p][n] for p = ty + 16i, n = tx + 16j:
    //    exp(cum_L)·S + Σ_u exp(cum_L − cum_u)·xdt[u][p]·B[u][n]
    {
      float acc[4][8] = {};
      int pr[4], nr[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = clampi(ty + 16 * i, P - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) nr[j] = clampi(tx + 16 * j, N - 1);
      for (int u = 0; u < L; ++u) {
        const float d = dec[u];
        float a[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[u * P + pr[i]] * d;
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[u * NS + nr[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      const float decay = expf(cum_last);
      __syncthreads();  // every read of the old state (step 4) is done
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (n < N) st[p * NS + n] = decay * st[p * NS + n] + acc[i][j];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < P * N; i += kSsdThreads) {
    const int p = i / N, n = i % N;
    state_out[sidx + i] = st[p * NS + n];
  }
}

}  // namespace repro_torch

extern "C" int ssd_scan_launch(const float* xdt, const float* loga,
                               const float* bm, const float* cm,
                               const float* state0, float* y, float* state_out,
                               int B, int S, int H, int P, int N, int L,
                               long long sxb, long long sxs, long long sxh,
                               long long slb, long long sls, long long slh,
                               long long sbb, long long sbs, long long scb,
                               long long scs, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0) return (int)cudaSuccess;
  if (L <= 0 || L > kMaxChunk || P > kMaxP || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)L * P + 2 * (size_t)L * (N + 1) +
                        (size_t)P * (N + 1) + (size_t)L * (L + 1) + 3 * L;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<B * H, kSsdThreads, bytes, (cudaStream_t)stream>>>(
      xdt, loga, bm, cm, state0, y, state_out, S, H, P, N, L, sxb, sxs, sxh,
      slb, sls, slh, sbb, sbs, scb, scs);
  return (int)cudaGetLastError();
}
