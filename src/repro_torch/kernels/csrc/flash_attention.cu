// Causal / sliding-window GQA attention with an online softmax.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_bhsd (the
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
// out_i = Σ_j softmax_j(q_i·k_j · D^−½) v_j in f32, written in q's dtype; a
// row that sees no key is written as 0.
//
// Bound: 4·B·H·(keys seen)·D flops (two products) against the bytes of q,
// k, v and o read or written once.  At the served shape (B, S, H, KV, D) =
// (4, 4096, 16, 1, 256) with window 2048 that is 4.1e11 flops and 285 MB:
// compute-bound (0.42 ms at the bf16 tensor-core peak, 6.2 ms at the f32
// CUDA-core peak, which this kernel runs on).
//
// Design (simple and right first; no tensor cores, no TMA): one block of 8
// warps per (query tile of 64, head, batch).  The Q tile is staged in shared
// memory in f32; a loop walks only the key tiles of 64 that the causal and
// window masks can reach, staging K transposed (Kt[d][j], padded to 65 so the
// transposing stores hit distinct banks) and V row-major, with 16-byte
// loads, 8 in flight a thread (stage_tile).  Each warp owns 8
// query rows; for S = QKᵀ a lane owns keys lane and lane + 32 (Q reads are
// shared-memory broadcasts, K reads conflict-free), then the online softmax
// per row (exp2 with the scale folded in, warp-shuffle max and sum), then
// P goes through shared memory (two float4 broadcasts a key) for O += PV,
// where a lane owns columns lane + 32·n of its 8 rows: 64 f32 accumulators.
// D is padded to Dp = 64, 128 or 256 with zeros in shared memory, so the
// inner loops run without guards; 214 KB of shared memory at Dp = 256 leaves
// one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

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

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KV, int D,
                                      int causal, int window, int dtype,
                                      void* stream) {
  using namespace repro_torch;
  if (D <= 0 || D > 256 || KV <= 0 || H % KV != 0 || H > 65535 ||
      B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, D, causal,
                                   window, st);
  return launch_d<float>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, st);
}
