// Single-query (decode) grouped-query attention over a KV cache.
//
// Replaces the TPU kernels of ray_tpu/ops/decode_attention.py:
//   paged_decode_attention  <- _paged_decode_kernel (paged pool + block table)
//   decode_attention        <- _decode_kernel       (dense [B, Hkv, S, D] cache)
// Both entry points share one kernel and differ only in how they find the
// K/V row of cache position `pos` (DenseRows / PagedRows below).
//
// What bounds it on the H100. Each cache position costs 2 * D * dtype bytes
// of K/V and 4 * n_rep * D FLOPs: about 2 FLOP/byte at n_rep = 2, far under
// the ~295 FLOP/byte ridge, so the work stays on the CUDA cores (an mma.sync
// tile would waste 14 of its 16 rows on two query rows). At the serving
// path's shape (8 rows of 64-96 positions, 1.5 MB of K/V, 0.4 us of bytes)
// no launch comes near the byte bound: a launch waits for a chain of
// dependent latencies (length -> block table -> K/V -> softmax -> combine ->
// store), and the design keeps that chain short. At a long context (1024
// positions, 16 MB at batch 8; 134 MB at batch 64) the bytes bound it, and
// the design keeps enough loads in flight to stream them.
//
// Design (one kernel for f32 and bf16, D = 64 or 128, any n_rep):
//   * registers only, one pass. A K/V row is read by a group of G lanes with
//     one 16-byte load each (G = 8 at D = 64 in bf16, 16 at D = 128 or in
//     f32, 32 at f32 D = 128), so a warp reads 32 / G rows an instruction.
//     Each lane keeps its d-slice of the block's R query rows in registers,
//     pre-scaled by scale * log2 e; a score is a partial dot product and
//     log2(G) xor-shuffles inside the group, a weight one ex2, and P.V
//     accumulates into the lane's own d-slice. No shared-memory staging;
//   * a warp takes tiles of P = (32 / G) * 4 consecutive positions (4 rows a
//     lane group), and issues every load of a tile before it uses any: the
//     block-table entries of the tile's pages are read once, one lane a
//     page, and reach the lanes by shuffle. Further tiles go through a
//     register double buffer: the next tile's loads are issued before the
//     current tile's math, and its table entries one tile ahead of that;
//   * every lane group keeps its own online softmax (m, l, acc); groups
//     merge by xor-shuffle, warps once at the end through shared memory in
//     warp order behind a single barrier;
//   * the query heads of a GQA group are taken R = 1, 2 or 4 at a time
//     (the register width); more heads are further blocks (grid x), each
//     reading the group's K/V again (from L2);
//   * the caller sets the launch from the shapes alone, never from the
//     lengths, which would cost a host sync a step (decode_attention.py:
//     decode_plan): one block a row and kv head (and pass of R heads). Where
//     those blocks fill the SMs, a block has 4 warps (the batch-64 shape:
//     one wave); where they leave SMs idle, 16 (a 1024-position row is 4
//     tiles a warp, the serving shape's row one). Splitting a row over a
//     cluster of blocks (flash-decoding) cost 1-5 us a launch more than 16
//     warps in one block at every cache the repo serves (<= 1024 positions;
//     PERF.md, section 6), so the kernel has no split. No atomics: two
//     launches give the same bits;
//   * positions at or past min(lengths[b], max_len) are never loaded and
//     never enter a sum; neither are table entries past the length, so the
//     garbage page 0 is never read, and the ragged tail needs no padded copy
//     of the cache. A row with lengths[b] <= 0 writes zeros.
#include "common.cuh"

namespace rtt {
namespace {

constexpr int kU = 4;  // K/V rows a lane group loads a tile

// the most warps a block of R query rows may have: the launch bound, which
// caps a thread's registers (128 at 16 warps: one or two rows fit; four rows
// take up to 232)
template <int R> __host__ __device__ constexpr int max_warps() { return R <= 2 ? 16 : 4; }
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the E values of a 16-byte vector as floats (bf16 -> f32 is a shift: exact)
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void unpack(const uint4& x, float (&f)[4]) {
    f[0] = __uint_as_float(x.x), f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z), f[3] = __uint_as_float(x.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void unpack(const uint4& x, float (&f)[8]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the magic number
// is made on the host: Granlund and Montgomery's method, as CUTLASS's
// FastDivmod)
struct FastDiv {
  int d;
  uint32_t mul, shift;
  static FastDiv make(int d) {
    FastDiv f{d, 0u, 0u};
    if (d != 1) {
      int l = 0;
      while ((1u << l) < static_cast<uint32_t>(d)) ++l;
      const uint32_t p = 31 + l;
      f.mul = static_cast<uint32_t>(((1ull << p) + d - 1) / d);
      f.shift = p - 32;
    }
    return f;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), mul) >> shift);
  }
};

struct DenseRows {  // k/v: [B, Hkv, S, D]
  int S, Hkv;
  __device__ __forceinline__ int tile_pages(int, int, int, int) const { return 0; }
  __device__ __forceinline__ int64_t row(int b, int g, int pos, int, int) const {
    return (static_cast<int64_t>(b) * Hkv + g) * S + pos;
  }
};

struct PagedRows {  // pages: [N, bs, Hkv, D]; tables: int32 [B, M]
  const int32_t* tables;
  int M, bs, Hkv;
  FastDiv div;
  // lane i: the table entry of the i-th page of the positions [first, last]
  // (last < the row's length, so no entry past it is read)
  __device__ __forceinline__ int tile_pages(int b, int first, int last, int lane) const {
    const int p = div(first) + lane;
    return p <= div(last) ? __ldg(tables + static_cast<int64_t>(b) * M + p) : 0;
  }
  __device__ __forceinline__ int64_t row(int, int g, int pos, int first, int pages) const {
    const int p = div(pos);
    const int page = __shfl_sync(kFull, pages, p - div(first));  // every lane takes part
    return (static_cast<int64_t>(page) * bs + (pos - p * bs)) * Hkv + g;
  }
};

// grid (Hkv * passes, B), W warps a block. Block (y, b) takes query heads
// g * n_rep + pass * R + [0, R) of kv head g = y % Hkv, pass = y / Hkv, and
// warp w the position tiles w, w + W, w + 2W, ...
template <typename T, int D, int R, typename Rows>
__global__ void __launch_bounds__(32 * max_warps<R>())
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int32_t* __restrict__ lengths, T* __restrict__ out, Rows rows, int H,
              int Hkv, int n_rep, int max_len, float sl2) {
  constexpr int kMaxWarps = max_warps<R>();
  constexpr int E = Vec<T>::E, G = D / E, NG = 32 / G, P = NG * kU;
  static_assert(P <= 32, "a tile's pages must fit a warp, one lane each");
  __shared__ float w_m[kMaxWarps][R], w_l[kMaxWarps][R];
  __shared__ float w_acc[kMaxWarps][R][D];

  const int W = blockDim.x / 32;
  const int g = blockIdx.x % Hkv, r0 = blockIdx.x / Hkv * R, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, grp = lane / G, sub = lane % G;
  const int len = max(0, min(__ldg(lengths + b), max_len));
  const int64_t head0 = static_cast<int64_t>(b) * H + static_cast<int64_t>(g) * n_rep + r0;

  float qf[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r0 + r < n_rep) {
      Vec<T>::unpack(load16(q + (head0 + r) * D + sub * E), qf[r]);
#pragma unroll
      for (int e = 0; e < E; ++e) qf[r][e] *= sl2;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[r][e] = 0.f;
    }
  }
  float m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY, l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  auto issue = [&](int t, int pages, uint4 (&kb)[kU], uint4 (&vb)[kU]) {
    const int first = t * P;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int pos = first + u * NG + grp;
      const int64_t off = rows.row(b, g, pos, first, pages) * D + sub * E;
      if (pos < len) {
        kb[u] = load16(k + off);
        vb[u] = load16(v + off);
      } else {
        kb[u] = vb[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  auto consume = [&](int t, const uint4 (&kb)[kU], const uint4 (&vb)[kU]) {
    float s[R][kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[E];
      Vec<T>::unpack(kb[u], kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qf[r][e], kf[e], x);
        s[r][u] = x;
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < kU; ++u) s[r][u] += __shfl_xor_sync(kFull, s[r][u], o);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (t * P + u * NG + grp >= len)
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][u] = -INFINITY;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int u = 1; u < kU; ++u) mx = fmaxf(mx, s[r][u]);
      const float m_new = fmaxf(m[r], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // nothing seen yet: p = 0, not NaN
      const float alpha = ex2(m[r] - base);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        s[r][u] = ex2(s[r][u] - base);
        sum += s[r][u];
      }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[E];
      Vec<T>::unpack(vb[u], vf);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(s[r][u], vf[e], acc[r][e]);
    }
  };

  // this warp's tiles: gw, gw + stride, ... while a tile starts before len
  const int gw = warp, stride = W;
  const int n_tiles = (len + P - 1) / P;
  const int n = gw < n_tiles ? (n_tiles - gw + stride - 1) / stride : 0;
  auto pages_of = [&](int t) {
    return rows.tile_pages(b, t * P, min(t * P + P, len) - 1, lane);
  };
  if (n > 0) {
    uint4 ka[kU], va[kU], kb[kU], vb[kU];
    issue(gw, pages_of(gw), ka, va);
    int pages = n > 1 ? pages_of(gw + stride) : 0;  // the table one tile ahead
    for (int i = 0; i < n; i += 2) {  // tiles i (buffer a) and i + 1 (buffer b)
      const int ta = gw + i * stride, tb = ta + stride;
      if (i + 1 < n) {
        issue(tb, pages, kb, vb);
        if (i + 2 < n) pages = pages_of(tb + stride);
      }
      consume(ta, ka, va);
      if (i + 2 < n) {
        issue(tb + stride, pages, ka, va);
        if (i + 3 < n) pages = pages_of(tb + 2 * stride);
      }
      if (i + 1 < n) consume(tb, kb, vb);
    }
  }

  // the warp's lane groups, merged by xor-shuffle (their d-slices line up)
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_o = __shfl_xor_sync(kFull, m[r], o);
      const float l_o = __shfl_xor_sync(kFull, l[r], o);
      const float m_new = fmaxf(m[r], m_o);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float wa = ex2(m[r] - base), wb = ex2(m_o - base);
      l[r] = l[r] * wa + l_o * wb;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] = acc[r][e] * wa + __shfl_xor_sync(kFull, acc[r][e], o) * wb;
    }
  }
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) w_acc[warp][r][sub * E + e] = acc[r][e];
      if (sub == 0) w_m[warp][r] = m[r], w_l[warp][r] = l[r];
    }
  }
  __syncthreads();

  // the block's warps, in warp order
  for (int o = threadIdx.x; o < R * D; o += blockDim.x) {
    const int r = o / D, d = o % D;
    float mx = -INFINITY;
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, w_m[w][r]);
    const float base = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f, a = 0.f;
    for (int w = 0; w < W; ++w) {
      const float wt = ex2(w_m[w][r] - base);
      sum += w_l[w][r] * wt;
      a += w_acc[w][r][d] * wt;
    }
    if (r0 + r < n_rep) out[(head0 + r) * D + d] = from_f32<T>(sum > 0.f ? a / sum : 0.f);
  }
}

template <typename T, int D, int R, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
                   Rows rows, int B, int H, int Hkv, int max_len, float scale, int warps,
                   cudaStream_t stream) {
  if (warps < 1 || warps > max_warps<R>()) return cudaErrorInvalidValue;
  const int n_rep = H / Hkv;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  decode_kernel<T, D, R, Rows><<<dim3(Hkv * ((n_rep + R - 1) / R), B), 32 * warps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), rows, H, Hkv, n_rep, max_len,
      sl2);
  return cudaGetLastError();
}

struct Plan {  // the launch shape the caller chose (decode_attention.py: decode_plan)
  int rows_per_pass, warps;
};

template <typename T, int D, typename Rows>
cudaError_t launch_rows(Plan p, const void* q, const void* k, const void* v,
                        const void* lengths, void* out, Rows rows, int B, int H, int Hkv,
                        int max_len, float scale, cudaStream_t s) {
  if (p.rows_per_pass == 1)
    return launch<T, D, 1>(q, k, v, lengths, out, rows, B, H, Hkv, max_len, scale, p.warps, s);
  if (p.rows_per_pass == 2)
    return launch<T, D, 2>(q, k, v, lengths, out, rows, B, H, Hkv, max_len, scale, p.warps, s);
  if (p.rows_per_pass == 4)
    return launch<T, D, 4>(q, k, v, lengths, out, rows, B, H, Hkv, max_len, scale, p.warps, s);
  return cudaErrorInvalidValue;
}

template <typename Rows>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v, const void* lengths,
             void* out, Rows rows, int B, int H, int Hkv, int max_len, float scale, Plan p,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || max_len < 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32 && D == 64)
    return launch_rows<float, 64>(p, q, k, v, lengths, out, rows, B, H, Hkv, max_len, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch_rows<float, 128>(p, q, k, v, lengths, out, rows, B, H, Hkv, max_len, scale,
                                   s);
  if (dtype == kBFloat16 && D == 64)
    return launch_rows<__nv_bfloat16, 64>(p, q, k, v, lengths, out, rows, B, H, Hkv, max_len,
                                          scale, s);
  if (dtype == kBFloat16 && D == 128)
    return launch_rows<__nv_bfloat16, 128>(p, q, k, v, lengths, out, rows, B, H, Hkv, max_len,
                                           scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rtt

extern "C" {

// q [B, H, D]; k_pages/v_pages [N, block_size, Hkv, D]; block_tables int32
// [B, max_blocks]; lengths int32 [B]; out [B, H, D]. All contiguous and
// 16-byte aligned, one dtype. The launch: rows_per_pass (1, 2 or 4) query
// heads a block takes, warps (up to 16 at rows_per_pass <= 2, else 4) a block.
int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                           const void* block_tables, const void* lengths, void* out, int B,
                           int H, int Hkv, int D, int block_size, int max_blocks, int dtype,
                           float scale, int rows_per_pass, int warps, void* stream) {
  if (block_size < 1 || max_blocks < 1) return cudaErrorInvalidValue;
  rtt::PagedRows rows{static_cast<const int32_t*>(block_tables), max_blocks, block_size, Hkv,
                      rtt::FastDiv::make(block_size)};
  return rtt::dispatch(dtype, D, q, k_pages, v_pages, lengths, out, rows, B, H, Hkv,
                       max_blocks * block_size, scale, {rows_per_pass, warps}, stream);
}

// q [B, H, D]; k/v [B, Hkv, S, D]; lengths int32 [B]; out [B, H, D]; the
// rest as above.
int decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                     void* out, int B, int H, int Hkv, int S, int D, int dtype, float scale,
                     int rows_per_pass, int warps, void* stream) {
  rtt::DenseRows rows{S, Hkv};
  return rtt::dispatch(dtype, D, q, k, v, lengths, out, rows, B, H, Hkv, S, scale,
                       {rows_per_pass, warps}, stream);
}

}  // extern "C"
