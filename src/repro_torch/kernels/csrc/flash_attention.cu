// Causal / sliding-window GQA attention with an online softmax.
//
// Replaces src/repro/kernels/flash_attention.py:72 flash_attention_bhsd (the
// Pallas kernel, grid (B·H, q blocks, kv blocks) with the running max, sum
// and accumulator in VMEM across the sequential kv axis).  Here it reads the
// model layout directly: q (B, Sq, H, D), k and v (B, Sk, KV, D), contiguous,
// bf16 or f32; query head h reads KV head h / (H / KV).  No transposed
// copies, no repeat of the KV heads, no padding.  Query i and key j sit at
// positions i and j; key j is seen by query i iff
//
//   j < Sk  and  (not causal or j ≤ i)  and  (window ≤ 0 or i − j < window),
//
// the true key length masked (the Pallas kernel masks the padded length).
// out_i = Σ_j softmax_j(q_i·k_j · D^−½) v_j with an f32 softmax, written in
// q's dtype; a row that sees no key is written as 0.
//
// Bound on an H100: 4·B·H·(keys seen)·D flops (two products) against the
// bytes of q, k, v and o read or written once.  At the served shape
// (B, S, H, KV, D) = (4, 4096, 16, 1, 256) with window 2048 that is 4.1e11
// flops and 285 MB: compute-bound, 0.42 ms at the 989 TFLOP/s bf16
// tensor-core peak (6.2 ms at the f32 CUDA-core peak).
//
// Two routes, chosen by kernels/flash_attention.py::route (deterministic, no
// fallback between them):
//
// * tensor-core route (flash_attention_tc_kernel): bf16 operands with
//   16-byte aligned rows (aligned bases, D a multiple of 8), D ≤ 256.  The
//   FA2 shape: a block of 8 warps owns 128 query rows of one (batch, head),
//   16 rows a warp.  Q stays in shared memory and is read as ldmatrix
//   fragments (in registers it would take 64 registers a thread at D = 256
//   on top of O's 128).  K and V tiles of 64 keys come in with cp.async
//   into a double-buffered ring, the next tile's load overlapping this
//   tile's products; only the key tiles that the masks can reach are
//   walked, and a warp skips a tile none of its rows sees.  S = QKᵀ is
//   mma.sync.m16n8k16 (bf16 in, f32 accumulators); the online softmax runs
//   on the S fragments (row max by quad shuffles, exp2 with the scale
//   folded in, partial row sums summed over the quad at the end); P is
//   rounded to bf16 in registers and fed straight back as the A operand of
//   O += PV, with V read by ldmatrix.trans.  O stays in f32 registers and is
//   written once.  D is padded with zeros in shared memory to Dp = 64, 128
//   or 256 (a template parameter); rows of 16-byte chunks are XOR-swizzled
//   so that ldmatrix reads 8 rows without bank conflicts.  Shared memory:
//   (128 + 4·64)·Dp·2 bytes, 192 KB at Dp = 256.
// * CUDA-core route (flash_attention_kernel): f32 operands (the f32 serve
//   checks hold attention at 1e-4, which TF32 or bf16 products would not
//   meet) and bf16 rows that are not whole 16-byte chunks (D = 33, 36) or
//   not 16-byte aligned.  One block of 8 warps per (query tile of 64, head,
//   batch): the Q tile staged in shared memory in f32, K transposed and V
//   row-major, with 16-byte loads where rows allow (stage_tile); each warp
//   owns 8 query rows, a lane keys lane and lane + 32 for S = QKᵀ, then the
//   online softmax (exp2, warp-shuffle max and sum), then P through shared
//   memory for O += PV on FMAs, 64 f32 accumulators a lane.  214 KB of
//   shared memory at Dp = 256 leaves one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

// ---------------------------------------------------------------------------
// CUDA-core route: f32, and bf16 that the tensor-core route does not take
// ---------------------------------------------------------------------------
constexpr int kFaQ = 64;        // query rows a block
constexpr int kFaK = 64;        // keys a tile
constexpr int kFaWarps = 8;
constexpr int kFaRows = kFaQ / kFaWarps;  // query rows a warp (8)
constexpr int kFaThreads = 32 * kFaWarps;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One 16-byte chunk of T values to f32: 8 bf16 or 4 f32.
__device__ __forceinline__ void unpack(uint4 c, float* out, float) {
  out[0] = __uint_as_float(c.x);
  out[1] = __uint_as_float(c.y);
  out[2] = __uint_as_float(c.z);
  out[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void unpack(uint4 c, float* out, __nv_bfloat16) {
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage rows row0 .. row0+63 of a (rows, D) slice with row stride `step`
// into shared memory as f32, zero past `rows` and past D: row-major
// (dst[r·Dp + d], Q and V) or transposed (dst[d·65 + r], K).  With `vec`
// (16-byte aligned rows, D a multiple of a chunk) each warp owns 8 rows and
// reads 4 consecutive 16-byte chunks a row a step (64 contiguous bytes),
// all its loads issued before any is used; the transposed stores then fall
// on 32 distinct banks (bf16), the row-major ones go out as float4s.
// Otherwise one element at a time.
template <typename T, int Dp, bool kTransposed>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base,
                                           int64_t step, int row0, int rows,
                                           int D, bool vec, float* dst,
                                           int warp, int lane, int tid) {
  constexpr int kStride = kTransposed ? kFaK + 1 : Dp;
  if (vec) {
    constexpr int kVe = 16 / sizeof(T);       // values a chunk
    constexpr int kSteps = Dp / kVe / 4;      // 4 chunks a row a step
    constexpr int kBatch = kSteps < 8 ? kSteps : 8;
    const int r = 8 * warp + (lane >> 2);
    const int j = row0 + r;
#pragma unroll
    for (int s0 = 0; s0 < kSteps; s0 += kBatch) {
      uint4 buf[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int d0 = (4 * (s0 + b) + (lane & 3)) * kVe;
        buf[b] = (j < rows && d0 < D)
                     ? __ldg(reinterpret_cast<const uint4*>(base + j * step +
                                                            d0))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int d0 = (4 * (s0 + b) + (lane & 3)) * kVe;
        float x[kVe];
        unpack(buf[b], x, T());
        if constexpr (kTransposed) {
#pragma unroll
          for (int e = 0; e < kVe; ++e) dst[(d0 + e) * kStride + r] = x[e];
        } else {
          float4* p = reinterpret_cast<float4*>(dst + r * kStride + d0);
#pragma unroll
          for (int e = 0; e < kVe / 4; ++e)
            p[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2],
                               x[4 * e + 3]);
        }
      }
    }
  } else {
    for (int idx = tid; idx < kFaQ * Dp; idx += kFaThreads) {
      const int r = idx / Dp, d = idx % Dp, j = row0 + r;
      const float x = (j < rows && d < D) ? to_f32(base[j * step + d]) : 0.0f;
      if constexpr (kTransposed)
        dst[d * kStride + r] = x;
      else
        dst[r * kStride + d] = x;
    }
  }
}

__host__ __device__ constexpr size_t fa_smem_floats(int dp) {
  return (size_t)kFaQ * dp + (size_t)dp * (kFaK + 1) + (size_t)kFaK * dp +
         (size_t)kFaWarps * kFaK * kFaRows;
}

template <typename T, int NK>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int H, int KV, int D, int causal, int window,
                       int vec, float scale_log2) {
  constexpr int Dp = 32 * NK;
  constexpr int KtS = kFaK + 1;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kFaQ][Dp]
  float* Kt = Qs + kFaQ * Dp;                   // [Dp][KtS]
  float* Vs = Kt + Dp * KtS;                    // [kFaK][Dp]
  float* Ps = Vs + kFaK * Dp;                   // [warp][kFaK][kFaRows]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kFaQ;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kvh = hh / (H / KV);
  const int64_t q_step = (int64_t)H * D, k_step = (int64_t)KV * D;
  const T* qb = q + ((int64_t)b * Sq * H + hh) * D;
  const T* kb = k + ((int64_t)b * Sk * KV + kvh) * D;
  const T* vb = v + ((int64_t)b * Sk * KV + kvh) * D;

  stage_tile<T, Dp, false>(qb + q0 * q_step, q_step, 0, Sq - q0, D, vec, Qs,
                           warp, lane, tid);

  // the key tiles some row of this query tile can see
  const int q_last = min(q0 + kFaQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kFaK;
  const int t_end = (k_end + kFaK - 1) / kFaK;

  const int r0 = warp * kFaRows;
  float m[kFaRows], l[kFaRows], acc[kFaRows][NK];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int n = 0; n < NK; ++n) acc[r][n] = 0.0f;
  }
  float* pw = Ps + warp * kFaK * kFaRows;

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kFaK;
    __syncthreads();  // the previous tile's K/V reads are done
    stage_tile<T, Dp, true>(kb, k_step, j0, Sk, D, vec, Kt, warp, lane, tid);
    stage_tile<T, Dp, false>(vb, k_step, j0, Sk, D, vec, Vs, warp, lane, tid);
    __syncthreads();

    // S = Q Kᵀ: rows r0..r0+7, keys lane and lane + 32
    float s[kFaRows][2];
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < Dp; d += 4) {
      float k0[4], k1[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        k0[c] = Kt[(d + c) * KtS + lane];
        k1[c] = Kt[(d + c) * KtS + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            &Qs[(r0 + r) * Dp + d]);
        s[r][0] = fmaf(qv.x, k0[0], s[r][0]);
        s[r][0] = fmaf(qv.y, k0[1], s[r][0]);
        s[r][0] = fmaf(qv.z, k0[2], s[r][0]);
        s[r][0] = fmaf(qv.w, k0[3], s[r][0]);
        s[r][1] = fmaf(qv.x, k1[0], s[r][1]);
        s[r][1] = fmaf(qv.y, k1[1], s[r][1]);
        s[r][1] = fmaf(qv.z, k1[2], s[r][1]);
        s[r][1] = fmaf(qv.w, k1[3], s[r][1]);
      }
    }

    // masks and the online softmax, one row at a time
    float p[kFaRows][2];
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      const int i = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + lane + 32 * c;
        const bool ok = j < Sk && (!causal || j <= i) &&
                        (window <= 0 || i - j < window);
        s[r][c] = ok ? s[r][c] * scale_log2 : -INFINITY;
      }
      float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float alpha = 1.0f;
      if (m_new == -INFINITY) {  // nothing seen yet in this row
        p[r][0] = p[r][1] = 0.0f;
      } else {
        alpha = exp2f(m[r] - m_new);
        p[r][0] = exp2f(s[r][0] - m_new);
        p[r][1] = exp2f(s[r][1] - m_new);
      }
      float ps = p[r][0] + p[r][1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NK; ++n) acc[r][n] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float4* dst = reinterpret_cast<float4*>(&pw[(lane + 32 * c) * kFaRows]);
      dst[0] = make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
      dst[1] = make_float4(p[4][c], p[5][c], p[6][c], p[7][c]);
    }
    __syncwarp();

    // O += P V
    const int jn = min(kFaK, Sk - j0);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      const float4 pa = *reinterpret_cast<const float4*>(&pw[jj * kFaRows]);
      const float4 pb =
          *reinterpret_cast<const float4*>(&pw[jj * kFaRows + 4]);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float vv = Vs[jj * Dp + lane + 32 * n];
        acc[0][n] = fmaf(pa.x, vv, acc[0][n]);
        acc[1][n] = fmaf(pa.y, vv, acc[1][n]);
        acc[2][n] = fmaf(pa.z, vv, acc[2][n]);
        acc[3][n] = fmaf(pa.w, vv, acc[3][n]);
        acc[4][n] = fmaf(pb.x, vv, acc[4][n]);
        acc[5][n] = fmaf(pb.y, vv, acc[5][n]);
        acc[6][n] = fmaf(pb.z, vv, acc[6][n]);
        acc[7][n] = fmaf(pb.w, vv, acc[7][n]);
      }
    }
    __syncwarp();  // P is read before the next tile rewrites it
  }

  T* ob = o + ((int64_t)b * Sq * H + hh) * D;
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int i = q0 + r0 + r;
    if (i >= Sq) continue;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int d = lane + 32 * n;
      if (d < D) from_f32(&ob[i * q_step + d], acc[r][n] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route: mma.sync + ldmatrix + cp.async, bf16
// ---------------------------------------------------------------------------
constexpr int kTcQ = 128;      // query rows a block (8 warps × 16)
constexpr int kTcKeys = 64;    // keys a tile
constexpr int kTcThreads = 256;

template <int Dp>
__host__ __device__ constexpr int fa_tc_smem() {
  return (kTcQ + 4 * kTcKeys) * Dp * 2;  // Q, then K and V twice each
}

// Byte offset of 16-byte chunk c of row r in a [rows][Dp] bf16 tile, the
// chunk index XOR-ed with r % 8: the 8 rows an ldmatrix reads at one logical
// chunk land in 8 distinct bank groups.
template <int Dp>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * Dp * 2 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c(16 × 8, f32) += a(16 × 16, bf16, row) · b(16 × 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Rows row0 .. row0 + kRows − 1 of a (rows, D) bf16 slice with row stride
// `step` into a swizzled [kRows][Dp] tile; rows past `rows` and chunks past
// D are zero-filled (cp.async with a source size of 0).
template <int Dp, int kRows>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          int64_t step, int row0, int rows,
                                          int D, int tid) {
  constexpr int kChunks = Dp / 8;
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks, j = row0 + r;
    const bool ok = j < rows && c * 8 < D;
    cp_async16(dst + swz<Dp>(r, c), ok ? base + j * step + c * 8 : base,
               ok ? 16 : 0);
  }
}

template <int Dp>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                          int H, int KV, int D, int causal, int window,
                          float scale_log2) {
  constexpr int kNb = Dp / 8;                    // n8 blocks of O
  constexpr uint32_t kTile = kTcKeys * Dp * 2;   // bytes of a K or V tile
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sQ = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sK = sQ + kTcQ * Dp * 2;
  const uint32_t sV = sK + 2 * kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kTcQ;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kvh = hh / (H / KV);
  const int64_t q_step = (int64_t)H * D, k_step = (int64_t)KV * D;
  const __nv_bfloat16* qb = q + ((int64_t)b * Sq * H + hh) * D;
  const __nv_bfloat16* kb = k + ((int64_t)b * Sk * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * Sk * KV + kvh) * D;

  // the key tiles some row of this query tile can see
  const int q_last = min(q0 + kTcQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kTcKeys;
  const int t_end = (k_end + kTcKeys - 1) / kTcKeys;

  load_tile<Dp, kTcQ>(sQ, qb, q_step, q0, Sq, D, tid);
  if (t_begin < t_end) {
    load_tile<Dp, kTcKeys>(sK, kb, k_step, t_begin * kTcKeys, Sk, D, tid);
    load_tile<Dp, kTcKeys>(sV, vb, k_step, t_begin * kTcKeys, Sk, D, tid);
  }
  cp_async_commit();

  // this thread's rows: i0 (fragment entries 0, 1) and i0 + 8 (2, 3)
  const int w0 = q0 + 16 * warp, w1 = w0 + 15;
  const int i0 = w0 + (lane >> 2);
  const int tq = lane & 3;
  float acc[kNb][4];
#pragma unroll
  for (int n = 0; n < kNb; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int t = t_begin; t < t_end; ++t) {
    const uint32_t buf = (uint32_t)((t - t_begin) & 1) * kTile;
    if (t + 1 < t_end) {  // the next tile into the other buffer
      load_tile<Dp, kTcKeys>(sK + (kTile - buf), kb, k_step,
                             (t + 1) * kTcKeys, Sk, D, tid);
      load_tile<Dp, kTcKeys>(sV + (kTile - buf), vb, k_step,
                             (t + 1) * kTcKeys, Sk, D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();

    const int j0 = t * kTcKeys;
    const bool unseen = (causal && j0 > w1) ||
                        (window > 0 && w0 - (j0 + kTcKeys - 1) >= window);
    if (!unseen) {
      // S = Q Kᵀ over 8 n8 blocks of keys
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sQ + swz<Dp>(16 * warp + (lane & 15),
                                    2 * kk + (lane >> 4)));
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, sK + buf + swz<Dp>(8 * n + (lane & 7) +
                                                 ((lane >> 4) << 3),
                                             2 * kk + ((lane >> 3) & 1)));
          mma_bf16(s[n], a, bk[0], bk[1]);
          mma_bf16(s[n + 1], a, bk[2], bk[3]);
        }
      }
      // scale (log2 domain) and, on a tile some row sees only in part, mask
      const bool partial = j0 + kTcKeys > Sk ||
                           (causal && j0 + kTcKeys - 1 > w0) ||
                           (window > 0 && w1 - j0 >= window);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale_log2;
          if (partial) {
            const int i = i0 + ((e >> 1) << 3);
            const int j = j0 + 8 * n + 2 * tq + (e & 1);
            const bool ok = j < Sk && (!causal || j <= i) &&
                            (window <= 0 || i - j < window);
            if (!ok) s[n][e] = -INFINITY;
          }
        }
      }
      // online softmax, rows i0 (r = 0) and i0 + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float mu = m_new == -INFINITY ? 0.0f : m_new;  // nothing seen
        const float alpha = exp2f(m[r] - mu);
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[n][2 * r] = exp2f(s[n][2 * r] - mu);
          s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - mu);
          sum += s[n][2 * r] + s[n][2 * r + 1];
        }
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }
      // O += P V: P's S fragments are the A fragments of 4 k16 key blocks
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < kNb; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sV + buf + swz<Dp>(16 * kk + (lane & 7) +
                                                       (((lane >> 3) & 1) << 3),
                                                   n + (lane >> 4)));
          mma_bf16(acc[n], pa, bv[0], bv[1]);
          mma_bf16(acc[n + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this buffer is read before the next load refills it
  }

  __nv_bfloat16* ob = o + ((int64_t)b * Sq * H + hh) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int i = i0 + 8 * r;
    if (i >= Sq) continue;
    const float inv = lr > 0.0f ? 1.0f / lr : 0.0f;
#pragma unroll
    for (int n = 0; n < kNb; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(&ob[i * q_step + d]) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv,
                                  acc[n][2 * r + 1] * inv);
    }
  }
}

template <int Dp>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int KV, int D, int causal, int window,
              cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<Dp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, fa_tc_smem<Dp>());
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  const dim3 grid((Sq + kTcQ - 1) / kTcQ, H, B);
  flash_attention_tc_kernel<Dp><<<grid, kTcThreads, fa_tc_smem<Dp>(), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Sk, H, KV, D, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

// The tensor-core route's preconditions: 16-byte aligned bases and rows of
// whole 16-byte chunks.
static int flash_attention_tc(const void* q, const void* k, const void* v,
                              void* o, int B, int Sq, int Sk, int H, int KV,
                              int D, int causal, int window, cudaStream_t st) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(o) || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_tc<64>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, st);
  if (D <= 128)
    return launch_tc<128>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, st);
  return launch_tc<256>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, st);
}

template <typename T, int NK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int D, int causal, int window,
           cudaStream_t st) {
  const size_t smem = fa_smem_floats(32 * NK) * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  // 16-byte loads need 16-byte aligned rows: aligned bases and whole chunks
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = aligned(q) && aligned(k) && aligned(v) &&
                  (D * (int)sizeof(T)) % 16 == 0;
  const dim3 grid((Sq + kFaQ - 1) / kFaQ, H, B);
  flash_attention_kernel<T, NK><<<grid, kFaThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, D, causal,
      window, vec, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KV, int D, int causal, int window,
             cudaStream_t st) {
  if (D <= 64)
    return launch<T, 2>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, st);
  if (D <= 128)
    return launch<T, 4>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, st);
  return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, st);
}

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16; route: 0 the CUDA-core kernel, 1 the
// tensor-core kernel (bf16 only).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KV, int D,
                                      int causal, int window, int dtype,
                                      int route, void* stream) {
  using namespace repro_torch;
  if (D <= 0 || D > 256 || KV <= 0 || H % KV != 0 || H > 65535 ||
      B > 65535 || (dtype != 0 && dtype != 1) || (route != 0 && route != 1) ||
      (route == 1 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1)
    return flash_attention_tc(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window,
                              st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, D, causal,
                                   window, st);
  return launch_d<float>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, st);
}
