// Fused big-vocab cross-entropy: per-token NLL without resident logits.
//
// Replaces src/repro/kernels/cross_entropy.py:66 fused_ce_nd (the Pallas
// kernel: a (token blocks, vocab blocks) grid whose vocab axis runs in order
// on the TPU, an online log-sum-exp and the label logit in VMEM scratch).
// For hidden (N, d), a head weight addressed as (V, d) through its strides
// (the tied embedding (V, d), or an untied (d, V) head read transposed, with
// no copy) and labels (N,):
//
//     nll_t = logsumexp_v(h_t · w_v) − h_t · w_{label_t},
//
// with f32 logits from the operands' dtype (float32 or bfloat16), the
// function repro_torch/kernels/ref.py::fused_ce_ref computes.  The logits
// never leave the chip.
//
// Bound on an H100: 2·N·V·d operations against hidden, weight and labels
// read once and the NLL written once.  At (16384, 2048, 50280) in bf16 that
// is 3.37e12 flops — 3.41 ms at the 989 TFLOP/s bf16 tensor-core peak, 50.4
// ms at the 67 TFLOP/s f32 CUDA-core peak — against 273 MB (0.08 ms):
// compute-bound, and only tensor cores come near the bound.
//
// Two routes, chosen by kernels/cross_entropy.py::route (deterministic, no
// fallback between them):
//
// * tensor-core route (fused_ce_tc_kernel): bf16 operands whose rows are
//   16-byte aligned (aligned bases, row strides a multiple of 8 elements) —
//   what TMA requires.  A GEMM with an online-softmax epilogue.  A CTA owns
//   128 tokens and walks the vocabulary in tiles of 256 with k-slices of 64
//   bf16 (one 128-byte swizzle row).  One producer warp keeps a ring of 4
//   shared-memory stages full with TMA loads (128-byte swizzle, mbarrier
//   completion; rows past N, columns past d and entries past V arrive as
//   TMA's zero fill), and two consumer warpgroups, 64 tokens each, run
//   wgmma on them (bf16 in, f32 accumulators in registers, one group kept in
//   flight while the previous stage is released).  The tied head is K-major
//   (m64n256k16, one instruction a k16 step); the untied head's transposed
//   view is MN-major, which wgmma reads as it lies (four m64n64k16 with the
//   transpose bit, one 64-wide swizzle atom each), so neither is copied.
//   Each finished vocab tile is reduced in registers: columns past V are
//   masked, the thread whose accumulator holds the label's column keeps that
//   logit, the row max is updated with quad shuffles, and each thread keeps
//   a partial exp-sum (base 2) under that max, summed over the quad at the
//   end.  N = 16384 gives 128 CTAs on 132 SMs; they walk the vocab tiles in
//   the same order, so the 206 MB head streams from HBM about once and
//   otherwise from L2.  cuTensorMapEncodeTiled is a driver-API call: it is
//   reached through cudaGetDriverEntryPoint, so nothing links -lcuda.
// * CUDA-core route (fused_ce_kernel): f32 operands (the f32 checks hold it
//   at 1e-5, which TF32 would not meet) and bf16 operands that TMA cannot
//   read (a base or row stride not 16-byte aligned).  A block of 128
//   threads owns 64 tokens and walks the vocabulary in tiles of 128: a
//   register-tiled product on CUDA cores (8 × 8 logits a thread) over
//   k-slices of 32 staged in shared memory as f32, then the same online
//   log-sum-exp with shuffles over the 16 threads that share a row.
//
// On both routes a ragged N, V or d is masked: rows past N load zeros and
// write nothing, columns past V are left out of the sums.
//
// The vocab-parallel form (fused_ce_partials_launch; the head is one
// rank's piece of the vocabulary, the labels offset by the piece's first
// id) writes, per token, the partials the pieces are merged from instead
// of the NLL: the running max m, the exp-sum l = Σ_v e^(h·w_v − m) and the
// label's logit z, 0 where the label falls outside [0, V).  The same two
// kernels compute them (m_out and l_out non-null); only the last write
// differs.  nll_t = M + log Σ_r l_r e^(m_r − M) − Σ_r z_r with M = max_r m_r
// over the pieces r (kernels/cross_entropy.py::VocabParallelCEFn).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// ---------------------------------------------------------------------------
// CUDA-core route: f32, and bf16 that the tensor-core route does not take
// ---------------------------------------------------------------------------
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
                float* __restrict__ m_out, float* __restrict__ l_out,
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
    if (tx == 0 && t < N) {
      if (m_out != nullptr) {  // the vocab-parallel partials
        nll[t] = lab_logit > kCeNegInf ? lab_logit : 0.0f;
        m_out[t] = m[i];
        l_out[t] = l[i];
      } else {
        nll[t] = logf(fmaxf(l[i], 1e-30f)) + m[i] - lab_logit;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route: TMA + wgmma, bf16
// ---------------------------------------------------------------------------
constexpr int kTcM = 128;          // tokens a CTA: two warpgroups of 64
constexpr int kTcN = 256;          // vocabulary entries a tile
constexpr int kTcK = 64;           // depth of a stage: 128 bytes of bf16
constexpr int kTcStages = 4;
constexpr int kTcConsumers = 256;  // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 32;  // and one producer warp
constexpr int kTcABytes = kTcM * kTcK * 2;     // 16 KB
constexpr int kTcBBytes = kTcN * kTcK * 2;     // 32 KB
constexpr int kTcStageBytes = kTcABytes + kTcBBytes;
// + 1024 so that the tiles can start on a 1024-byte boundary (the 128-byte
// swizzle repeats every 8 rows of 128 bytes), + the full and empty barriers
constexpr int kTcSmem = 1024 + kTcStages * kTcStageBytes + 2 * kTcStages * 8;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One TMA box of a 2-D tensor map into shared memory; c0 is the inner
// (contiguous) coordinate.  Completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// D(64 × 256) (+)= A(64 × 16) · B(16 × 256), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n256_kmajor(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 × 64) (+)= A(64 × 16) · B(16 × 64), B MN-major (transpose bit)
__device__ __forceinline__ void wgmma_n64_mnmajor(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A row's running max and exp-sum over one finished vocab tile held as
// accumulator fragments: x[e] for e = 0 .. 63 are this thread's columns
// 8·(e/2) + 2·(lane % 4) + e % 2 of the tile (masked ones at kCeNegInf).
struct RowState {
  float m, l, ll;  // running max, this thread's partial exp-sum, label logit
};

template <int kOff>
__device__ __forceinline__ void tile_row_update(RowState& st, const float* acc,
                                                int v0, int lab, int lane) {
  // label logit: the thread whose fragment holds the label's column
  const int c = lab - v0;
  if (c >= 0 && c < kTcN && ((c & 7) >> 1) == (lane & 3)) {
#pragma unroll
    for (int j = 0; j < kTcN / 8; ++j)
      if (j == (c >> 3)) st.ll = (c & 1) ? acc[4 * j + kOff + 1]
                                         : acc[4 * j + kOff];
  }
  float mx = kCeNegInf;
#pragma unroll
  for (int j = 0; j < kTcN / 8; ++j)
    mx = fmaxf(mx, fmaxf(acc[4 * j + kOff], acc[4 * j + kOff + 1]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(st.m, mx);
  const float base = m_new * kLog2e;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kTcN / 8; ++j) {
    s += exp2f(fmaf(acc[4 * j + kOff], kLog2e, -base));
    s += exp2f(fmaf(acc[4 * j + kOff + 1], kLog2e, -base));
  }
  st.l = st.l * exp2f((st.m - m_new) * kLog2e) + s;
  st.m = m_new;
}

__device__ __forceinline__ void row_finish(RowState st, int row, int N,
                                           float* __restrict__ nll,
                                           float* __restrict__ m_out,
                                           float* __restrict__ l_out,
                                           int lane) {
  st.l += __shfl_xor_sync(0xffffffffu, st.l, 1);
  st.l += __shfl_xor_sync(0xffffffffu, st.l, 2);
  st.ll = fmaxf(st.ll, __shfl_xor_sync(0xffffffffu, st.ll, 1));
  st.ll = fmaxf(st.ll, __shfl_xor_sync(0xffffffffu, st.ll, 2));
  if ((lane & 3) == 0 && row < N) {
    if (m_out != nullptr) {  // the vocab-parallel partials
      nll[row] = st.ll > kCeNegInf ? st.ll : 0.0f;
      m_out[row] = st.m;
      l_out[row] = st.l;
    } else {
      nll[row] = logf(fmaxf(st.l, 1e-30f)) + st.m - st.ll;
    }
  }
}

// kMnMajor: the head's V axis is contiguous (an untied head's transposed
// view); otherwise its d axis is (the tied embedding).
template <bool kMnMajor>
__global__ void __launch_bounds__(kTcThreads, 1)
fused_ce_tc_kernel(const __grid_constant__ CUtensorMap tm_h,
                   const __grid_constant__ CUtensorMap tm_w,
                   const int* __restrict__ labels, float* __restrict__ nll,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int N, int V, int D) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTcStages * kTcStageBytes);
  uint64_t* empty = full + kTcStages;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTcM;
  const int n_vt = (V + kTcN - 1) / kTcN;
  const int n_kt = (D + kTcK - 1) / kTcK;
  const int total = n_vt * n_kt;
  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // the producer warp: one thread keeps the ring of stages full
    if (tid == kTcConsumers) {
      for (int g = 0; g < total; ++g) {
        const int s = g % kTcStages;
        mbar_wait(&empty[s], ((g / kTcStages) & 1) ^ 1);
        const int v0 = (g / n_kt) * kTcN, k0 = (g % n_kt) * kTcK;
        uint8_t* a = smem + s * kTcStageBytes;
        uint8_t* b = a + kTcABytes;
        mbar_arrive_tx(&full[s], kTcStageBytes);
        tma_load_2d(a, &tm_h, &full[s], k0, t0);
        if (kMnMajor) {
#pragma unroll
          for (int q = 0; q < kTcN / 64; ++q)
            tma_load_2d(b + q * 8192, &tm_w, &full[s], v0 + 64 * q, k0);
        } else {
          tma_load_2d(b, &tm_w, &full[s], k0, v0);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns tokens t0 + 64·wg .. + 63; this
  // thread's accumulator rows are r0 and r0 + 8
  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int r0 = t0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int r1 = r0 + 8;
  const int lab0 = r0 < N ? labels[r0] : -1;
  const int lab1 = r1 < N ? labels[r1] : -1;
  RowState st0 = {kCeNegInf, 0.0f, kCeNegInf};
  RowState st1 = {kCeNegInf, 0.0f, kCeNegInf};
  float acc[kTcN / 2];
#pragma unroll
  for (int i = 0; i < kTcN / 2; ++i) acc[i] = 0.0f;

  int g = 0;
  for (int vt = 0; vt < n_vt; ++vt) {
    int prev = -1;
    for (int kt = 0; kt < n_kt; ++kt, ++g) {
      const int s = g % kTcStages;
      mbar_wait(&full[s], (g / kTcStages) & 1);
      const uint32_t a = smem_u32(smem + s * kTcStageBytes) + wg * 8192;
      const uint32_t b = smem_u32(smem + s * kTcStageBytes + kTcABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcK / 16; ++kk) {
        // k16 step kk: 32 bytes along a K-major row, 16 rows (2048 bytes)
        // down an MN-major tile
        const uint64_t da = sw128_desc(a + 32 * kk, 16, 1024);
        const int scale_d = (kt > 0 || kk > 0) ? 1 : 0;
        if (kMnMajor) {
#pragma unroll
          for (int q = 0; q < kTcN / 64; ++q)
            wgmma_n64_mnmajor(acc + 32 * q, da,
                              sw128_desc(b + 8192 * q + 2048 * kk, 1024, 1024),
                              scale_d);
        } else {
          wgmma_n256_kmajor(acc, da, sw128_desc(b + 32 * kk, 16, 1024),
                            scale_d);
        }
      }
      wgmma_commit();
      // the previous stage's products are done: release it
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < kTcN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    const int v0 = vt * kTcN;
    if (v0 + kTcN > V) {  // the ragged last tile: columns past V drop out
      const int cq = v0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < kTcN / 8; ++j) {
        if (cq + 8 * j >= V) acc[4 * j] = acc[4 * j + 2] = kCeNegInf;
        if (cq + 8 * j + 1 >= V) acc[4 * j + 1] = acc[4 * j + 3] = kCeNegInf;
      }
    }
    tile_row_update<0>(st0, acc, v0, lab0, lane);
    tile_row_update<2>(st1, acc, v0, lab1, lane);
  }
  row_finish(st0, r0, N, nll, m_out, l_out, lane);
  row_finish(st1, r1, N, nll, m_out, l_out, lane);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda)
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map: `inner` contiguous elements a row, `outer` rows
// `pitch` elements apart, boxes of box_inner × box_outer, 128-byte swizzle,
// zero fill out of bounds.
static bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* base,
                     long long inner, long long outer, long long pitch,
                     int box_inner, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kMnMajor>
static int launch_tc(const CUtensorMap& th, const CUtensorMap& tw,
                     const int* labels, float* nll, float* m_out,
                     float* l_out, int N, int V, int D, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_ce_tc_kernel<kMnMajor>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  fused_ce_tc_kernel<kMnMajor><<<(N + kTcM - 1) / kTcM, kTcThreads, kTcSmem,
                                  s>>>(th, tw, labels, nll, m_out, l_out,
                                       N, V, D);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p, long long pitch_elems) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (pitch_elems * 2) % 16 == 0;
}

static int fused_ce_tc(const void* hidden, const void* weight,
                       const int* labels, float* nll, float* m_out,
                       float* l_out, int N, int V, int D, long long shn,
                       long long swv, long long swd, cudaStream_t s) {
  // what TMA reads: 16-byte aligned bases and row pitches; one of the
  // head's strides is 1
  const bool mn_major = swd != 1;
  if (!aligned16(hidden, shn) || (mn_major && swv != 1) ||
      !aligned16(weight, mn_major ? swd : swv))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap th, tw;
  if (!make_map(enc, &th, hidden, D, N, shn, kTcK, kTcM))
    return (int)cudaErrorInvalidValue;
  if (mn_major) {
    if (!make_map(enc, &tw, weight, V, D, swd, 64, kTcK))
      return (int)cudaErrorInvalidValue;
    return launch_tc<true>(th, tw, labels, nll, m_out, l_out, N, V, D, s);
  }
  if (!make_map(enc, &tw, weight, D, V, swv, kTcK, kTcN))
    return (int)cudaErrorInvalidValue;
  return launch_tc<false>(th, tw, labels, nll, m_out, l_out, N, V, D, s);
}

// One launch on the route asked for: the NLL (m_out null) or the
// vocab-parallel partials (z in nll, m in m_out, l in l_out).
static int ce_dispatch(const void* hidden, const void* weight,
                       const int* labels, float* nll, float* m_out,
                       float* l_out, int N, int V, int D, long long shn,
                       long long swv, long long swd, int dtype, int route,
                       void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return fused_ce_tc(hidden, weight, labels, nll, m_out, l_out, N, V, D,
                       shn, swv, swd, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCeRows - 1) / kCeRows);
  if (dtype == 0) {
    fused_ce_kernel<float><<<grid, kCeThreads, 0, s>>>(
        (const float*)hidden, (const float*)weight, labels, nll, m_out, l_out,
        N, V, D, shn, swv, swd);
  } else if (dtype == 1) {
    fused_ce_kernel<__nv_bfloat16><<<grid, kCeThreads, 0, s>>>(
        (const __nv_bfloat16*)hidden, (const __nv_bfloat16*)weight, labels,
        nll, m_out, l_out, N, V, D, shn, swv, swd);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (hidden and weight alike); route: 0 the
// CUDA-core kernel, 1 the tensor-core kernel (bf16 only)
extern "C" int fused_ce_launch(const void* hidden, const void* weight,
                               const int* labels, float* nll, int N, int V,
                               int D, long long shn, long long swv,
                               long long swd, int dtype, int route,
                               void* stream) {
  return repro_torch::ce_dispatch(hidden, weight, labels, nll, nullptr,
                                  nullptr, N, V, D, shn, swv, swd, dtype,
                                  route, stream);
}

// The vocab-parallel partials of a piece (V its width, labels offset by
// its first id): z (the label's logit, 0 outside [0, V)), m and l, (N,)
// f32 each; dtype and route as above
extern "C" int fused_ce_partials_launch(const void* hidden,
                                        const void* weight, const int* labels,
                                        float* z, float* m, float* l, int N,
                                        int V, int D, long long shn,
                                        long long swv, long long swd,
                                        int dtype, int route, void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  return repro_torch::ce_dispatch(hidden, weight, labels, z, m, l, N, V, D,
                                  shn, swv, swd, dtype, route, stream);
}
