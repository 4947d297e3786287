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
// CUDA-core peak; 0.47 ms for the 3 × 7.8e10 flops of the 3xTF32 products
// at the 494.7 TFLOP/s dense TF32 peak, which only wgmma reaches).
//
// Two routes, chosen by repro_torch/kernels/ssd_scan.py::route.
//
// Tensor-core route (ssd_cb_kernel, then ssd_tc_kernel): the operands that
// cp.async can stage in 16-byte pieces (the served shapes).
//  * C·Bᵀ once per (batch row, chunk): ssd_cb_kernel writes the masked
//    L×L product (8 MB at (8, 4096)) on CUDA cores in plain f32; every head
//    of the row reads it and applies its own decay.
//  * One block of 2·P/16 warps per (batch, segment, head): the warp pair
//    2i, 2i + 1 owns state rows p ∈ [16i, 16i + 16), each warp half of n,
//    as mma accumulators in registers for the whole walk (32 floats a
//    thread at N = 128).
//  * The products run on mma.sync.m16n8k8 tf32 with the 3xTF32 split
//    (a = hi + lo, a·b ≈ lo·hi + hi·lo + hi·hi, f32 sums), which keeps f32
//    accuracy; plain TF32 would miss the 1e-5 tolerance.  y is computed
//    transposed, yᵀ (P × L) = exp(cum)⊙(S·Cᵀ) + xdtᵀ·scoresᵀ: the state's
//    accumulator tile is reused as the A fragment (its columns 2q, 2q + 1
//    play the k slots q, q + 4, and C is read in the same order), so the
//    state never goes through shared memory.  Each warp of a pair forms a
//    partial over its half of n and every other k-tile of the
//    lower-triangle intra-chunk product; the pair sums them through shared
//    memory.  The state update (exp(cum_L − cum_u)·xdt)ᵀ·B is summed per
//    chunk in fresh accumulators and folded into the carried state with one
//    FFMA, so the tensor cores' own summation never runs across chunks.
//  * Every product runs over whole 64 × 128 tiles: rows and columns past
//    the chunk, P and N are zeros in shared memory, so no branch splits the
//    unrolled products and ptxas interleaves their loads and mma chains
//    (a guard on each 8 × 8 tile made it issue them one after another).
//  * Row strides of shared memory (P + 8, N + 8, L + 4) keep every
//    fragment load free of bank conflicts.  86 KB a block: two blocks an
//    SM.  cp.async groups overlap the loads with the products: xdt loads
//    under the decays and S·Cᵀ, B (into C's buffer) under the intra-chunk
//    product, the next chunk's C·Bᵀ tile under the state update.
//  * Parallel across chunks: when B·H blocks cannot fill the card (batch
//    1), the sequence is cut into T segments.  A state-only pass (the same
//    kernel, no y) runs each segment but the last from a zero state and
//    writes its end state and its summed log decay; the full pass starts
//    segment k from state0 folded through those: S ← exp(Σ loga)·S + S_end.
//    Only T − 1 states per (batch, head) go through device memory.
//  * What bounds it: mma.sync issues TF32 products at well under the
//    dense TF32 peak that wgmma reaches, and the staging through the
//    load/store pipe and the decay pass's expf are not hidden under them.
//
// CUDA-core route (ssd_scan_kernel, the first port): any operands, one
// block of 256 threads per (b, h) walking its chunks in order with the
// (P, N) state in shared memory, register-tiled products (4×4 and 4×8
// outputs a thread) on CUDA cores; C·Bᵀ is recomputed per head over the
// full square.  It stays for rows cp.async cannot stage (a stride or a
// base off 16 bytes) and as the second route the checks compare.
//
// Both routes read the operands through their strides (the last dimension
// contiguous), so the model's (B, S, H, P) layout needs no transpose; a
// ragged last chunk is masked by zero-filling the tile rows past S (the
// reference pads the same zeros) and writing no y for them; exp(cum_t −
// cum_u) for u > t (+inf, and inf·0 is NaN) is never formed.
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

// ---------------------------------------------------------------------------
// The tensor-core route
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                  // rows of a chunk tile (L ≤ 64)
constexpr int kXS = kMaxP + 8;             // row stride of xs
constexpr int kBS = kMaxN + 8;             // row stride of cbuf
constexpr int kSS = kTile + 4;             // row stride of sc
// two warps per 16 state rows, each owning half of n
constexpr int kTcMaxThreads = 2 * 32 * kMaxP / 16;
// floats of the partial-product exchange: 4 t-tiles × 4 values a lane
constexpr int kXchg = (kTcMaxThreads / 32) * 16 * 32;
// shared floats of the state-only pass (xs, cbuf, cum, ecum, dec), and of
// the full pass (those, then sc and the exchange): 86 KB, two blocks an SM
constexpr int kTcStateFloats = kTile * kXS + kTile * kBS + 3 * kTile;
constexpr int kTcFullFloats = kTcStateFloats + kTile * kSS + kXchg;

constexpr uint32_t kTf32Mask = 0xffffe000u;  // sign, exponent, 10 bits

// x = hi + lo to 2^-21 relative, each part a TF32 value (3xTF32): hi is x
// truncated to TF32, lo the exact f32 remainder truncated again: two
// integer ops and a subtraction, no conversion instruction.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An m16 × k8 A fragment, split.  With g = lane / 4 and q = lane % 4, a0 is
// (row g, k q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4).
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

// d += a·b at f32 accuracy: b = (b0 at (k q, n g), b1 at (k q + 4, n g));
// the two small cross products first, then hi·hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every committed group but the newest has landed
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// rows [0, rows) of `cols` floats (a multiple of 4) from src (row stride
// sstride) to dst (row stride dstride), a warp a row; rows from `valid` on
// are zeros
__device__ __forceinline__ void stage_rows(float* dst, int dstride,
                                           const float* src, int64_t sstride,
                                           int rows, int valid, int cols) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < rows; t += nwarps) {
    const bool in = t < valid;
    const float* row = in ? src + t * sstride : src;
    for (int j = 4 * lane; j < cols; j += 128)
      cp_async16(dst + t * dstride + j, row + j, in);
  }
}

// warp 0: cum ← the inclusive prefix sum of cum[0, kTile) (zeros past the
// chunk), ecum[t] = exp(cum_t), dec[u] = exp(cum_last − cum_u)
__device__ __forceinline__ void chunk_decays(float* cum, float* ecum,
                                             float* dec, int lane) {
  const int i0 = 2 * lane, i1 = i0 + 1;
  const float v0 = cum[i0], v1 = cum[i1];
  float incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  const float last = __shfl_sync(0xffffffffu, incl, 31);
  const float c0 = excl + v0;
  cum[i0] = c0;
  cum[i1] = incl;
  ecum[i0] = expf(c0);
  ecum[i1] = expf(incl);
  dec[i0] = expf(last - c0);
  dec[i1] = expf(last - incl);
}

// grid (chunks, B): the masked C·Bᵀ of one (batch row, chunk) in plain f32
// on CUDA cores — cb (B, chunks, LT, LT), LT = L rounded up to 8, entry
// [t][u] = C_t·B_u for u ≤ t < valid rows, 0 elsewhere.
__global__ void __launch_bounds__(kSsdThreads)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cb, int S, int N, int L, int64_t sbb,
              int64_t sbs, int64_t scb, int64_t scs) {
  extern __shared__ float smem[];
  const int NS = N + 1;
  const int LT = (L + 7) & ~7;
  float* bsm = smem;            // [LT][NS]
  float* csm = smem + LT * NS;  // [LT][NS]
  const int c = blockIdx.x, b = blockIdx.y;
  const int s0 = c * L;
  const int lc = clampi(L, S - s0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* bb = bm + b * sbb + (int64_t)s0 * sbs;
  const float* cc = cm + b * scb + (int64_t)s0 * scs;
  for (int i = tid; i < LT * N; i += kSsdThreads) {
    const int t = i / N, n = i - t * N;
    const bool in = t < lc;
    bsm[t * NS + n] = in ? bb[(int64_t)t * sbs + n] : 0.0f;
    csm[t * NS + n] = in ? cc[(int64_t)t * scs + n] : 0.0f;
  }
  __syncthreads();
  float acc[4][4] = {};
  int tr[4], ur[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tr[i] = clampi(ty + 16 * i, LT - 1);
    ur[i] = clampi(tx + 16 * i, LT - 1);
  }
  for (int n = 0; n < N; ++n) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = csm[tr[i] * NS + n];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bsm[ur[j] * NS + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
  float* out = cb + ((int64_t)b * gridDim.x + c) * LT * LT;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = tx + 16 * j;
      if (t < LT && u < LT) out[t * LT + u] = u <= t ? acc[i][j] : 0.0f;
    }
  }
}

// grid (H, segments, B), block 64·⌈P/16⌉: the warp pair 2i, 2i + 1 owns
// state rows p ∈ [16i, 16i + 16), warp 2i + h the n-tiles [8h, 8h + 8).
// Every product runs over whole tiles (64 rows of t and u, 128 columns of
// n): rows and columns past the chunk, P and N are zeros in shared memory
// and in the state, so they add nothing, and no branch splits the
// unrolled products (ptxas then interleaves their loads and mma chains).
// Segment k walks chunks [k·cps, (k + 1)·cps).  FULL: y, starting from
// state0 folded through the earlier segments' end states, and the final
// state from the last segment.  Otherwise (the state-only pass, segments
// 0 … T − 2): each segment's end state from a zero state into seg_state
// (B, T − 1, H, P, N), and its summed log decay into seg_decay
// (B, T − 1, H).
template <bool FULL>
__global__ void __launch_bounds__(kTcMaxThreads, 2)
ssd_tc_kernel(const float* __restrict__ xdt, const float* __restrict__ loga,
              const float* __restrict__ bm, const float* __restrict__ cm,
              const float* __restrict__ cb, const float* __restrict__ state0,
              float* __restrict__ seg_state, float* __restrict__ seg_decay,
              float* __restrict__ y, float* __restrict__ state_out, int S,
              int H, int P, int N, int L, int cps, int64_t sxb, int64_t sxs,
              int64_t sxh, int64_t slb, int64_t sls, int64_t slh, int64_t sbb,
              int64_t sbs, int64_t scb, int64_t scs) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [kTile][kXS] xdt rows t, columns p
  float* cbuf = xs + kTile * kXS;   // [kTile][kBS] C rows t, then B rows u
  float* cum = cbuf + kTile * kBS;  // [kTile] prefix sums of loga
  float* ecum = cum + kTile;        // [kTile] exp(cum_t)
  float* dec = ecum + kTile;        // [kTile] exp(cum_last − cum_u)
  float* sc = dec + kTile;          // [kTile][kSS] decayed scores (FULL)
  float* xchg = sc + kTile * kSS;   // [warps][16][32] partials (FULL)

  const int h = blockIdx.x, seg = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int half = warp & 1, p0 = 16 * (warp >> 1);
  const int LT = (L + 7) & ~7;  // chunk rows, rounded up to 8
  const int nc = (S + L - 1) / L;
  const int c0 = seg * cps, c1 = min(nc, c0 + cps);

  // zeros in the columns staging never writes (p ≥ P, n ≥ N)
  const int zero_floats = FULL ? kTcFullFloats : kTcStateFloats;
  for (int i = tid; i < zero_floats; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  // this warp's half of the carried state as mma accumulators: st[j][e] is
  // S[p][n] at p = p0 + g + 8·(e / 2), n = 8·(8·half + j) + 2q + e % 2
  float st[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.0f;
  if (FULL) {
    // S_in = state0, then S_in ← exp(decay_j)·S_in + S_end_j for j < seg
    const int ts = gridDim.y - 1;
    for (int k = -1; k < seg; ++k) {
      const float* src;
      float a = 0.0f;
      if (k < 0) {
        if (state0 == nullptr) continue;
        src = state0 + ((int64_t)b * H + h) * P * N;
      } else {
        const int64_t i = ((int64_t)b * ts + k) * H + h;
        src = seg_state + i * P * N;
        a = expf(seg_decay[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * (8 * half + j) + 2 * q;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = p0 + g + 8 * hh;
          if (n < N && p < P) {
            const float2 v =
                *reinterpret_cast<const float2*>(src + (int64_t)p * N + n);
            st[j][2 * hh] = fmaf(a, st[j][2 * hh], v.x);
            st[j][2 * hh + 1] = fmaf(a, st[j][2 * hh + 1], v.y);
          }
        }
      }
    }
  }

  const float* xb = xdt + b * sxb + h * sxh;
  const float* lb = loga + b * slb + h * slh;
  const float* bb = bm + b * sbb;
  const float* cbm = cm + b * scb;
  const float* cbb = cb + (int64_t)b * nc * LT * LT;
  float* yb = y + ((int64_t)b * S * H + h) * P;  // y is (B, S, H, P)
  float decay_sum = 0.0f;

  for (int c = c0; c < c1; ++c) {
    const int s0 = c * L;
    const int lc = clampi(L, S - s0);  // valid rows of this chunk

    // 1. stage the chunk (rows past S are zeros, as the reference pads):
    // loga and C (or, in the state-only pass, B) first, then xdt, which the
    // full pass needs only from step 4 and so loads under steps 2-3; after
    // the first chunk the C·Bᵀ tile is already on its way (step 5)
    for (int t = tid; t < kTile; t += blockDim.x)
      cp_async4(cum + t, lb + (int64_t)(s0 + min(t, lc - 1)) * sls, t < lc);
    if (FULL) {
      stage_rows(cbuf, kBS, cbm + (int64_t)s0 * scs, scs, LT, lc, N);
      if (c == c0)
        stage_rows(sc, kSS, cbb + (int64_t)c * LT * LT, LT, LT, LT, LT);
    } else {
      stage_rows(cbuf, kBS, bb + (int64_t)s0 * sbs, sbs, LT, lc, N);
    }
    cp_async_commit();
    stage_rows(xs, kXS, xb + (int64_t)s0 * sxs, sxs, LT, lc, P);
    cp_async_commit();
    if (FULL)
      cp_async_wait_older();
    else
      cp_async_wait_all();
    __syncthreads();

    // 2. the chunk's decays
    if (warp == 0) chunk_decays(cum, ecum, dec, lane);
    __syncthreads();
    const float cum_last = cum[kTile - 1];
    decay_sum += cum_last;

    if (FULL) {
      // 3. this head's decay on the row's C·Bᵀ: u ≤ t only, 0 above (lane
      // u and u + 32 of rows t ≡ warp mod warps) ...
      {
        const float cu0 = cum[lane], cu1 = cum[lane + 32];
#pragma unroll 4
        for (int t = warp; t < LT; t += nwarps) {
          const float ct = cum[t];
          float* row = sc + t * kSS;
          row[lane] = lane <= t ? row[lane] * expf(ct - cu0) : 0.0f;
          row[lane + 32] =
              lane + 32 <= t ? row[lane + 32] * expf(ct - cu1) : 0.0f;
        }
      }
      // ... and this warp's partial of yᵀ (16 rows p × 64 t): S·Cᵀ over its
      // half of n, the state's accumulator tile as the A fragment (columns
      // 2q, 2q + 1 as the k slots q, q + 4; C read in the same order)
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const FragA a(st[j][0], st[j][2], st[j][1], st[j][3]);
        const float* cr = cbuf + g * kBS + 8 * (8 * half + j) + 2 * q;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 cv =
              *reinterpret_cast<const float2*>(cr + 8 * nt * kBS);
          mma3(acc[nt], a, cv.x, cv.y);
        }
      }
      cp_async_wait_all();
      __syncthreads();  // C read, the scores decayed, xdt in

      // 4. B into C's buffer, under the rest of y
      stage_rows(cbuf, kBS, bb + (int64_t)s0 * sbs, sbs, LT, lc, N);
      cp_async_commit();
      // the partial times exp(cum_t) on column t, plus xdtᵀ·scoresᵀ over
      // this warp's k-tiles u ∈ [8kb, 8kb + 8), kb ≡ half mod 2: the lower
      // triangle (t-tiles from 2i on; half 1's diagonal tile is zeros)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float e0 = ecum[8 * nt + 2 * q], e1 = ecum[8 * nt + 2 * q + 1];
        acc[nt][0] *= e0;
        acc[nt][1] *= e1;
        acc[nt][2] *= e0;
        acc[nt][3] *= e1;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kb = 2 * i + half;
        const float* xr = xs + (8 * kb + q) * kXS + p0 + g;
        const FragA a(xr[0], xr[8], xr[4 * kXS], xr[4 * kXS + 8]);
        const float* sr = sc + g * kSS + 8 * kb + q;
#pragma unroll
        for (int nt = 2 * i; nt < 8; ++nt)
          mma3(acc[nt], a, sr[8 * nt * kSS], sr[8 * nt * kSS + 4]);
      }
      // the pair's partials summed through shared memory: half 0 keeps
      // t-tiles 0-3, half 1 tiles 4-7
      float* mine = xchg + warp * 16 * 32 + lane;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(4 * i + e) * 32] = half ? acc[i][e] : acc[4 + i][e];
      __syncthreads();  // the partials are out; every read of sc is done

      // 5. the next chunk's C·Bᵀ tile, under the rest of the chunk (a group
      // of its own, empty after the last chunk)
      if (c + 1 < c1)
        stage_rows(sc, kSS, cbb + (int64_t)(c + 1) * LT * LT, LT, LT, LT,
                   LT);
      cp_async_commit();
      // 6. y[t][p] for this warp's t-tiles, the chunk's valid rows
      const float* theirs = xchg + (warp ^ 1) * 16 * 32 + lane;
      float* yc = yb + (int64_t)s0 * H * P + p0 + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = 4 * half + i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * nt + 2 * q + (e & 1), dp = 8 * (e >> 1);
          const float v =
              (half ? acc[4 + i][e] : acc[i][e]) + theirs[(4 * i + e) * 32];
          if (t < lc && p0 + g + dp < P) yc[(int64_t)t * H * P + dp] = v;
        }
      }
      cp_async_wait_older();
      __syncthreads();  // B staged; every read of xchg is done
    }

    // 7. S ← exp(cum_L)·S + (dec ⊙ xdt)ᵀ·B on this warp's n-tiles: the
    // chunk's sum in fresh accumulators, folded in with one FFMA
    const float decay = expf(cum_last);
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.0f;
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      const float* xr = xs + (8 * kb + q) * kXS + p0 + g;
      const float d0 = dec[8 * kb + q], d1 = dec[8 * kb + q + 4];
      const FragA a(xr[0] * d0, xr[8] * d0, xr[4 * kXS] * d1,
                    xr[4 * kXS + 8] * d1);
      const float* br = cbuf + (8 * kb + q) * kBS + 64 * half + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) mma3(ds[j], a, br[8 * j], br[8 * j + 4 * kBS]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = fmaf(decay, st[j][e], ds[j][e]);
    __syncthreads();  // every read of this chunk's xs and cbuf is done
  }

  float* dst = nullptr;
  if (FULL) {
    if (seg == (int)gridDim.y - 1)
      dst = state_out + ((int64_t)b * H + h) * P * N;
  } else {
    const int64_t i = ((int64_t)b * gridDim.y + seg) * H + h;
    dst = seg_state + i * P * N;
    if (tid == 0) seg_decay[i] = decay_sum;
  }
  if (dst != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * (8 * half + j) + 2 * q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = p0 + g + 8 * hh;
        if (n < N && p < P)
          *reinterpret_cast<float2*>(dst + (int64_t)p * N + n) =
              make_float2(st[j][2 * hh], st[j][2 * hh + 1]);
      }
    }
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace repro_torch

// route 0: the CUDA-core kernel (cb, seg_state, seg_decay unused); route 1:
// the tensor-core kernels, with cb (B, chunks, LT, LT) and, for segments >
// 1, seg_state (B, segments − 1, H, P, N) and seg_decay (B, segments − 1, H)
// as scratch; segment k walks chunks [k·cps, (k + 1)·cps).
extern "C" int ssd_scan_launch(const float* xdt, const float* loga,
                               const float* bm, const float* cm,
                               const float* state0, float* y, float* state_out,
                               float* cb, float* seg_state, float* seg_decay,
                               int B, int S, int H, int P, int N, int L,
                               int segments, int cps, int route,
                               long long sxb, long long sxs, long long sxh,
                               long long slb, long long sls, long long slh,
                               long long sbb, long long sbs, long long scb,
                               long long scs, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0) return (int)cudaSuccess;
  if (L <= 0 || L > kMaxChunk || P > kMaxP || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (route == 0) {
    const size_t floats = (size_t)L * P + 2 * (size_t)L * (N + 1) +
                          (size_t)P * (N + 1) + (size_t)L * (L + 1) + 3 * L;
    const size_t bytes = floats * sizeof(float);
    err = cudaFuncSetAttribute(ssd_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ssd_scan_kernel<<<B * H, kSsdThreads, bytes, st>>>(
        xdt, loga, bm, cm, state0, y, state_out, S, H, P, N, L, sxb, sxs, sxh,
        slb, sls, slh, sbb, sbs, scb, scs);
    return (int)cudaGetLastError();
  }
  const int nc = (S + L - 1) / L;
  if (route != 1 || P % 4 != 0 || N % 4 != 0 || segments < 1 || cps < 1 ||
      (long long)(segments - 1) * cps >= (nc > 0 ? nc : 1))
    return (int)cudaErrorInvalidValue;
  const int LT = (L + 7) & ~7;
  const int threads = 64 * ((P + 15) / 16);
  if (nc > 0) {
    const size_t bytes = 2 * (size_t)LT * (N + 1) * sizeof(float);
    if ((err = allow_smem(ssd_cb_kernel, bytes)) != cudaSuccess)
      return (int)err;
    ssd_cb_kernel<<<dim3(nc, B), kSsdThreads, bytes, st>>>(
        bm, cm, cb, S, N, L, sbb, sbs, scb, scs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (segments > 1) {
    const size_t bytes = kTcStateFloats * sizeof(float);
    if ((err = allow_smem(ssd_tc_kernel<false>, bytes)) != cudaSuccess)
      return (int)err;
    ssd_tc_kernel<false><<<dim3(H, segments - 1, B), threads, bytes, st>>>(
        xdt, loga, bm, cm, cb, state0, seg_state, seg_decay, y, state_out, S,
        H, P, N, L, cps, sxb, sxs, sxh, slb, sls, slh, sbb, sbs, scb, scs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t bytes = kTcFullFloats * sizeof(float);
  if ((err = allow_smem(ssd_tc_kernel<true>, bytes)) != cudaSuccess)
    return (int)err;
  ssd_tc_kernel<true><<<dim3(H, segments, B), threads, bytes, st>>>(
      xdt, loga, bm, cm, cb, state0, seg_state, seg_decay, y, state_out, S, H,
      P, N, L, cps, sxb, sxs, sxh, slb, sls, slh, sbb, sbs, scb, scs);
  return (int)cudaGetLastError();
}
