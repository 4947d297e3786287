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
// Sources and out rows.  The table has n rows, one an out row; its indices
// address n_src ≥ n source rows of Δ and θ, out row i's self term reading
// source row i, and c, θ', c' are (n, D).  n_src = n is the epilogue of all
// of W; on the decentralized mesh the sources are a rank's own rows and
// then the halo rows it received, the table remapped onto them.
//
// Bound: Δ, θ, c read once and θ', c' written once, plus the tables:
// 5·n·D·4 + n·(2m+1)·4 bytes against 4·n·(m+1)·D + 4·n·D flops — about
// 5 flop/byte at m ≈ 24, far below the card's ~20 f32 flop/byte, so the
// kernel is memory-bound.  Each Δ/θ row is gathered by about m+1 rows, so
// the kernel reaches the bound only if those re-reads hit L2.
//
// Two routes, chosen in Python by neighbor_gossip.route (a pure function of
// n, m and the gossip dtype):
//
// * row_block (the first port, neighbor_gossip_kernel below): every gather
//   goes to device memory and is served by L2 — each Δ/θ row is read m+1
//   times, about 4.9 TB/s from L2 at n = 4096.
// * stripe (stripe_gossip_kernel further below): a block holds a 4-column
//   stripe of Δ and θ over all n rows in shared memory and serves every
//   gather from there, so device memory is touched once per element.
//
// Row-block design (simple and right first): a block owns kRows rows ×
// kThreads columns; a thread owns one column of those rows and keeps 2·kRows
// f32 accumulators in registers, so each gathered neighbor row is one coalesced
// 512-byte read per block.  The block's idx/w entries are staged in shared
// memory kSlots slots at a time (every thread reads the same entry: a
// broadcast), so any m fits.  The grid is 1-D with the row blocks of one
// D tile consecutive: the rows those blocks gather, a kThreads-column
// stripe of Δ and θ, stay in L2 while the tile is worked on.  The ragged D
// edge and the last row block are masked; n is not padded.  An index
// outside [0, n_src) is never dereferenced: that row's outputs become NaN.
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
                       float* __restrict__ c_out, int n, int n_src, int m,
                       int64_t D, unsigned row_blocks, float eta, float corr) {
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
          if ((unsigned)j < (unsigned)n_src) {
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

// ---------------------------------------------------------------------------
// The stripe route
// ---------------------------------------------------------------------------
//
// Design.  A block owns a stripe of kStripeCols columns of one variable over
// all n_src source rows.  It stages Δ and θ of the stripe in dynamic shared
// memory once
// (f32 by cp.async, every row in flight at once; or narrowed to bf16 —
// half the bytes — for gossip_dtype = bfloat16), then walks the rows in
// chunks of kStripeChunk, one row a thread: the row's m+1 gathers are
// shared-memory reads of one 16-byte (f32) or 8-byte (bf16) row of the
// stripe, summed into 4 f32 accumulators.  c and, for bf16, the f32 Δ_i of
// the correction (in f32 the stripe holds it) are loaded a chunk ahead;
// the outputs stream out once.  Gathers of one warp are conflict-free when
// its 32 rows' neighbours are distinct mod 8 (f32) or mod 16 (bf16), as on
// the exponential graph, whose rows i..i+31 share their offsets ±2^k.
//
// The (n, m) table.  Every stripe walks the whole table, in chunks of
// kStripeChunk rows (idx, w, w_ii), double-buffered in shared memory: the
// block's threads copy chunk k+1 by cp.async (16 bytes a thread at a time,
// a chunk's last few words one by one) while they work on chunk k.
//
// Bound.  The gathers from shared memory are cheap; what bounds the route
// is the bytes each SM takes in from L2: the table once per stripe
// (n·(2m+1)·4 bytes, 754 KB at n = 4096, m = 23), and the stripe and c in
// 16-byte pieces of 32-byte sectors, against 4 columns of output.
//
// The x and y variables of a round share the table and the grid: blocks
// [0, sx) are x's stripes, the next sy are y's.
//
// Summation order.  Each output is the row-block kernel's: the self term
// w_ii·Δ_i first, then slots 0…m−1 by fmaf, then the same epilogue
// expressions, so the two routes agree bit for bit.  An index outside
// [0, n_src) is never dereferenced: its slot reads row 0 with weight NaN,
// so the row's sums become NaN, as there.
//
// Shared memory: 2·n_src·4·(4 or 2) bytes for the stripe + 2·kStripeChunk·
// (2m+1)·4 bytes for the table buffers (227,328 B at n = 4096, m = 23 in
// f32, within the 227 KB a block may use).

constexpr int kStripeCols = 4;        // columns per stripe
constexpr int kStripeThreads = 256;   // one row a thread
constexpr int kStripeChunk = kStripeThreads;  // table rows per buffer
constexpr size_t kMaxStripeSmem = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a stripe row: 4 f32 (16 bytes) or 4 bf16 (8 bytes)
template <bool BF16>
struct StripeRow {
  using T = float4;
  __device__ static T pack(float4 v) { return v; }
  __device__ static float4 unpack(T r) { return r; }
};

template <>
struct StripeRow<true> {
  using T = uint2;
  __device__ static uint32_t bits(float v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static T pack(float4 v) {
    return make_uint2(bits(v.x) | (bits(v.y) << 16),
                      bits(v.z) | (bits(v.w) << 16));
  }
  __device__ static float4 unpack(T r) {
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  }
};

// one variable of the pair
struct StripeVar {
  const float* delta;
  const float* theta;
  const float* c;
  float* theta_out;
  float* c_out;
  long long D;
  float eta, corr;
  int stripes;  // ceil(D / kStripeCols)
};

__host__ __device__ inline size_t stripe_bytes(int n, bool bf16) {
  const size_t b = (size_t)n * kStripeCols * (bf16 ? 2 : 4);
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline size_t table_stage_bytes(int m) {
  return (size_t)kStripeChunk * (2 * (size_t)m + 1) * 4;
}

__host__ inline size_t stripe_smem_bytes(int n, int m, bool bf16) {
  return 2 * stripe_bytes(n, bf16) + 2 * table_stage_bytes(m);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// read-once operands and outputs: streamed past L2, which keeps the
// stripes' Δ and θ that neighbouring stripes share a sector with
__device__ __forceinline__ float4 ld4_stream(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4_stream(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// 16 bytes from global memory into shared memory, bypassing registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// `count` 4-byte words from global src to shared dst (both 16-byte
// aligned): 16 bytes a cp.async, the last count % 4 words by plain loads
template <class T>
__device__ __forceinline__ void copy_words(T* dst, const T* src, int count,
                                           int tid) {
  const int whole = count & ~3;
  for (int e = 4 * tid; e < whole; e += 4 * kStripeThreads)
    cp_async16(dst + e, src + e);
  if (tid < count - whole) dst[whole + tid] = src[whole + tid];
}

// VEC: every D a multiple of 4 and every (n, D) operand 16-byte aligned, so
// a stripe row is one 16-byte load or store.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(kStripeThreads, 1)
stripe_gossip_kernel(const int* __restrict__ nidx,
                     const float* __restrict__ nw,
                     const float* __restrict__ self_w, StripeVar x,
                     StripeVar y, int n, int n_src, int m) {
  using Row = StripeRow<BF16>;
  using RowT = typename Row::T;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;

  const bool is_x = (int)blockIdx.x < x.stripes;
  const StripeVar v = is_x ? x : y;
  const int stripe = is_x ? (int)blockIdx.x : (int)blockIdx.x - x.stripes;
  const int64_t c0 = (int64_t)stripe * kStripeCols;
  const int64_t D = v.D;
  const int ncols = D - c0 < kStripeCols ? (int)(D - c0) : kStripeCols;

  const size_t sb = stripe_bytes(n_src, BF16);
  RowT* sd = reinterpret_cast<RowT*>(smem);
  RowT* st = reinterpret_cast<RowT*>(smem + sb);
  unsigned char* tab = smem + 2 * sb;
  const size_t stage = table_stage_bytes(m);
  const int nch = (n + kStripeChunk - 1) / kStripeChunk;
  auto chunk_rows = [&](int k) {
    return min(kStripeChunk, n - k * kStripeChunk);
  };
  auto stage_idx = [&](int s) {
    return reinterpret_cast<int*>(tab + s * stage);
  };
  auto stage_w = [&](int s) {
    return reinterpret_cast<float*>(tab + s * stage +
                                    (size_t)kStripeChunk * m * 4);
  };
  auto stage_sw = [&](int s) {
    return reinterpret_cast<float*>(tab + s * stage +
                                    (size_t)kStripeChunk * m * 8);
  };
  // this thread's share of chunk k into buffer s, as one cp.async group
  auto load_chunk = [&](int k, int s) {
    const int r0 = k * kStripeChunk, rc = chunk_rows(k);
    copy_words(stage_idx(s), nidx + (int64_t)r0 * m, rc * m, tid);
    copy_words(stage_w(s), nw + (int64_t)r0 * m, rc * m, tid);
    copy_words(stage_sw(s), self_w + r0, rc, tid);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  load_chunk(0, 0);
  // stage Δ and θ of the stripe (narrowed for bf16) while chunk 0 loads:
  // every row's 16 bytes in flight at once (cp.async for f32, register
  // batches for bf16, which narrows on the way)
  if (VEC && !BF16) {
    for (int r = tid; r < n_src; r += kStripeThreads) {
      const int64_t off = (int64_t)r * D + c0;
      cp_async16(&sd[r], v.delta + off);
      cp_async16(&st[r], v.theta + off);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else if (VEC) {
    constexpr int kBatch = 8;
    for (int r0 = tid; r0 < n_src; r0 += kBatch * kStripeThreads) {
      float4 a[kBatch], b[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int r = r0 + q * kStripeThreads;
        const int64_t off = (int64_t)r * D + c0;
        a[q] = r < n_src ? ld4(v.delta + off)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        b[q] = r < n_src ? ld4(v.theta + off)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int r = r0 + q * kStripeThreads;
        if (r < n_src) {
          sd[r] = Row::pack(a[q]);
          st[r] = Row::pack(b[q]);
        }
      }
    }
  } else {
    for (int e = tid; e < n_src * kStripeCols; e += kStripeThreads) {
      const int r = e / kStripeCols, q = e % kStripeCols;
      const int64_t off = (int64_t)r * D + c0 + q;
      const float a = q < ncols ? v.delta[off] : 0.f;
      const float b = q < ncols ? v.theta[off] : 0.f;
      if (BF16) {
        reinterpret_cast<__nv_bfloat16*>(sd)[e] = __float2bfloat16_rn(a);
        reinterpret_cast<__nv_bfloat16*>(st)[e] = __float2bfloat16_rn(b);
      } else {
        reinterpret_cast<float*>(sd)[e] = a;
        reinterpret_cast<float*>(st)[e] = b;
      }
    }
  }

  const float kNaN = __int_as_float(0x7fc00000);
  // the epilogue's c (and, for bf16, f32 Δ_i) of this thread's row in the
  // next chunk, loaded a chunk ahead so that its latency hides under the
  // gathers
  float4 c_next = make_float4(0.f, 0.f, 0.f, 0.f), d_next = c_next;
  auto load_epilogue = [&](int i) {
    if (VEC && i < n) {
      const int64_t off = (int64_t)i * D + c0;
      c_next = ld4_stream(v.c + off);
      if (BF16) d_next = ld4_stream(v.delta + off);
    }
  };
  load_epilogue(tid);
  for (int k = 0; k < nch; ++k) {
    const int s = k & 1;
    const int r0 = k * kStripeChunk, rc = chunk_rows(k);
    // chunk k (and, at k = 0, the stripe) has landed; chunk k+1 loads
    // into the other buffer, which chunk k−1 has left
    if (k + 1 < nch) {
      load_chunk(k + 1, s ^ 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const int* tidx = stage_idx(s);
    const float* tw = stage_w(s);
    const float* tsw = stage_sw(s);
    const float4 cv = c_next;
    float4 d32 = d_next;
    load_epilogue(r0 + kStripeChunk + tid);
    if (tid < rc) {
      const int i = r0 + tid;
      const int64_t off = (int64_t)i * D + c0;
      const float4 di = Row::unpack(sd[i]);
      const float4 ti = Row::unpack(st[i]);
      if (!BF16) d32 = di;
      const float sw = narrow<BF16>(tsw[tid]);
      float4 ad = make_float4(sw * di.x, sw * di.y, sw * di.z, sw * di.w);
      float4 at = make_float4(sw * ti.x, sw * ti.y, sw * ti.z, sw * ti.w);
      const int* ri = tidx + tid * m;
      const float* rw = tw + tid * m;
#pragma unroll 4
      for (int q = 0; q < m; ++q) {
        const int j = ri[q];
        // an index outside [0, n_src) reads row 0 with weight NaN: the
        // row's sums become NaN and stay NaN
        const bool ok = (unsigned)j < (unsigned)n_src;
        const float w = ok ? narrow<BF16>(rw[q]) : kNaN;
        const float4 a = Row::unpack(sd[ok ? j : 0]);
        const float4 b = Row::unpack(st[ok ? j : 0]);
        ad.x = fmaf(w, a.x, ad.x);
        ad.y = fmaf(w, a.y, ad.y);
        ad.z = fmaf(w, a.z, ad.z);
        ad.w = fmaf(w, a.w, ad.w);
        at.x = fmaf(w, b.x, at.x);
        at.y = fmaf(w, b.y, at.y);
        at.z = fmaf(w, b.z, at.z);
        at.w = fmaf(w, b.w, at.w);
      }
      const float eta = v.eta, corr = v.corr;
      if (VEC) {
        st4_stream(v.theta_out + off,
                   make_float4(at.x + eta * ad.x, at.y + eta * ad.y,
                               at.z + eta * ad.z, at.w + eta * ad.w));
        st4_stream(v.c_out + off,
                   make_float4(cv.x + corr * (d32.x - ad.x),
                               cv.y + corr * (d32.y - ad.y),
                               cv.z + corr * (d32.z - ad.z),
                               cv.w + corr * (d32.w - ad.w)));
      } else {
        const float accd[4] = {ad.x, ad.y, ad.z, ad.w};
        const float acct[4] = {at.x, at.y, at.z, at.w};
#pragma unroll
        for (int q = 0; q < kStripeCols; ++q) {
          if (q < ncols) {
            v.theta_out[off + q] = acct[q] + eta * accd[q];
            v.c_out[off + q] =
                v.c[off + q] + corr * (v.delta[off + q] - accd[q]);
          }
        }
      }
    }
    // every thread is done with buffer s before chunk k+2 loads into it
    __syncthreads();
  }
}

template <bool BF16, bool VEC>
cudaError_t launch_stripe(const int* nidx, const float* nw,
                          const float* self_w, const StripeVar& x,
                          const StripeVar& y, int n, int n_src, int m,
                          size_t smem, cudaStream_t stream) {
  auto kernel = stripe_gossip_kernel<BF16, VEC>;
  static bool opted_in = false;  // the 227 KB opt-in, once per kernel
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxStripeSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  kernel<<<x.stripes + y.stripes, kStripeThreads, smem, stream>>>(
      nidx, nw, self_w, x, y, n, n_src, m);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

}  // namespace repro_torch

extern "C" int sparse_gossip_launch(const int* nidx, const float* nw,
                                    const float* self_w, const float* delta,
                                    const float* theta, const float* c,
                                    float* theta_out, float* c_out, int n,
                                    int n_src, int m, long long D,
                                    float eta_s, float corr_scale, int bf16,
                                    void* stream) {
  using namespace repro_torch;
  if (n_src < n) return (int)cudaErrorInvalidValue;
  if (n <= 0 || D <= 0) return (int)cudaSuccess;
  const unsigned long long row_blocks = (n + kNgRows - 1) / kNgRows;
  const unsigned long long col_tiles = (D + kNgThreads - 1) / kNgThreads;
  if (row_blocks * col_tiles > 0x7fffffffULL)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(row_blocks * col_tiles));
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    neighbor_gossip_kernel<true><<<grid, kNgThreads, 0, st>>>(
        nidx, nw, self_w, delta, theta, c, theta_out, c_out, n, n_src, m,
        (int64_t)D, (unsigned)row_blocks, eta_s, corr_scale);
  else
    neighbor_gossip_kernel<false><<<grid, kNgThreads, 0, st>>>(
        nidx, nw, self_w, delta, theta, c, theta_out, c_out, n, n_src, m,
        (int64_t)D, (unsigned)row_blocks, eta_s, corr_scale);
  return (int)cudaGetLastError();
}

// The stripe route over one or two variables that share the table (Dy = 0:
// x alone), n out rows over n_src ≥ n source rows.  The three table
// operands must be 16-byte aligned.
extern "C" int sparse_gossip_pair_launch(
    const int* nidx, const float* nw, const float* self_w, const float* dx,
    const float* tx, const float* cx, float* tox, float* cox, long long Dx,
    float eta_x, float corr_x, const float* dy, const float* ty,
    const float* cy, float* toy, float* coy, long long Dy, float eta_y,
    float corr_y, int n, int n_src, int m, int bf16, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || n_src < n || m < 0 || Dx < 0 || Dy < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stripe_smem_bytes(n_src, m, bf16 != 0);
  if (smem > kMaxStripeSmem || !aligned16(nidx) || !aligned16(nw) ||
      !aligned16(self_w))
    return (int)cudaErrorInvalidValue;
  const long long sx = (Dx + kStripeCols - 1) / kStripeCols;
  const long long sy = (Dy + kStripeCols - 1) / kStripeCols;
  if (sx + sy == 0) return (int)cudaSuccess;
  if (sx + sy > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec =
      Dx % 4 == 0 && Dy % 4 == 0 && aligned16(dx) && aligned16(tx) &&
      aligned16(cx) && aligned16(tox) && aligned16(cox) &&
      (Dy == 0 || (aligned16(dy) && aligned16(ty) && aligned16(cy) &&
                   aligned16(toy) && aligned16(coy)));
  const StripeVar x{dx, tx, cx, tox, cox, Dx, eta_x, corr_x, (int)sx};
  const StripeVar y{dy, ty, cy, toy, coy, Dy, eta_y, corr_y, (int)sy};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16)
    err = vec ? launch_stripe<true, true>(nidx, nw, self_w, x, y, n, n_src,
                                          m, smem, st)
              : launch_stripe<true, false>(nidx, nw, self_w, x, y, n, n_src,
                                           m, smem, st);
  else
    err = vec ? launch_stripe<false, true>(nidx, nw, self_w, x, y, n, n_src,
                                           m, smem, st)
              : launch_stripe<false, false>(nidx, nw, self_w, x, y, n, n_src,
                                            m, smem, st);
  return (int)err;
}
