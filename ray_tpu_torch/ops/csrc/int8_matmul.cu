// Int8 weight-only matrix product (W8A16):
//   out[M, N] = (x[M, K] @ w[K, N]) * scales[N]
// with x in f32 or bf16, w int8 (N contiguous, the JAX layout), scales f32
// per output column, the sum in f32, and out in x's dtype.
//
// Replaces the TPU kernel of ray_tpu/ops/quantization.py:
//   int8_matmul  <- _int8_matmul_kernel (grid (M/bm, N/bn, K/bk), K innermost,
//                   an f32 VMEM accumulator, the scale applied on the last k-step)
//
// What bounds it on the H100: bytes. At the serving path's shapes (decode
// M = 8 rows, prefill M = 64, K = 1024 or 4096, N = 512 to 4096) a weight
// byte meets at most 64 rows, 128 FLOPs a byte, under the ~295 FLOP/byte
// ridge: 1.3 to 1.5 microseconds of stream for w1. At that size the stream
// is not what a launch waits for: it waits for the chain from the launch to
// the first load, through the products, to the last store. The design keeps
// that chain short and the loads wide and many. Two routes, chosen by the
// caller from x's dtype and the shape:
//
// bf16 x (every serving path; N % 16 == 0, K % 8 == 0, aligned bases) ->
// int8_matmul_mma_kernel, on the tensor cores, computing the TRANSPOSED
// product out^T[N, M] = w^T[N, K] . x^T[K, M] with per-warp mma.sync
// m16n8k16, so that the weights go from global memory to registers to the
// A operand and never through shared memory:
//   * a warp owns 8 * CPT output columns (CPT = 16, 8 or 4 columns a thread:
//     the widest whose tiles still fill the SMs) of up to NB = 8, 16, 32 or
//     64 rows of x. Thread (g = lane / 4, q = lane % 4) loads CPT int8 of
//     its columns from each of the k rows 2q, 2q + 1, 2q + 8, 2q + 9 of a
//     16-row step (one 16-, 8- or 4-byte ld.global.nc each), converts them
//     exactly (PRMT + FADD to f32, one CVT to a bf16 pair; 8 bits of
//     magnitude fit bf16's mantissa) and has the A fragments of CPT / 2
//     products: rows g and g + 8 of product j are columns 2j and 2j + 1 of
//     the thread's CPT; x^T is the B operand, 8 rows of x a product;
//   * the 16 (NB = 8) or 8 warps of a block split K: warp i takes the steps
//     i, i + NW, ... and starts the loads of its next 4 (2 at CPT = 16)
//     steps before it uses the first, so a decode block has 8 to 32 KB in
//     flight right after the launch. Each warp leaves its partial tile in
//     shared memory and, after one barrier, the tile is summed in warp order;
//   * x (NB rows of a chunk of 16384 / NB k) is copied by cp.async into one
//     of two buffers, the next chunk's copy under this chunk's products: one
//     barrier a chunk, and a decode launch has one chunk. Rows past M and k
//     past K are zero-filled; the weights' loads past K are predicated off;
//   * the weights are read once per 64 rows of x (once at M <= 64), not once
//     per 8 rows;
//   * K goes over a thread-block cluster (gridDim.x, at most 8) only where
//     the column tiles leave half the card idle and a split keeps 2048 k
//     rows (w2 at decode): each block sums a slice of the tile over all
//     ranks in rank order through distributed shared memory, all the remote
//     reads started before the first add. No atomics and no scratch in global
//     memory: a launch is bitwise repeatable. With one split the launch is a
//     plain one: a cluster launch costs about a microsecond.
//   Why mma.sync and not wgmma: a wgmma version of the same transposed
//   product (weights as the register A operand of m64nNBk16, x staged as the
//   swizzled K-major B operand, K over a cluster of 8) was built first and
//   measured: w1 at decode 0.0127 ms, prefill 0.0202, against 0.0097 and
//   0.0148 for this kernel (PERF.md). A warpgroup's product needs 64 output
//   columns a warp-quarter, so few, wide tiles and a cluster for every
//   shape, and each 16-row step costs a fence, a commit and a wait. Decode
//   rows (M < 16) take this route too: the scalar route below takes 0.0183
//   ms for w1.
//
// f32 x (the parity checks: atol 1e-5 x max|plain| rules out rounding x to
// bf16), and bf16 x at shapes the tensor-core route does not take (ragged N
// or K) -> int8_matmul_kernel, scalar FMAs: 8-row x 32-column tiles, 256
// threads, the weights loaded 4 bytes a thread (N % 4 == 0) or byte by byte
// and converted in registers; x for the split's k range staged in f32 in
// shared memory, 512 k rows at a time (one barrier pair for a whole decode
// split); the 32 k-lanes reduced by warp shuffles, then shared memory; the K
// split over a cluster reduced by rank 0 in rank order. Ragged M, N and K
// are masked, not padded. It reads the weights once per 8 rows. (16-byte
// loads, 16 columns and 128 accumulators a thread, were measured slower:
// 0.0296 against 0.0182 ms for w1.)
#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace rtt {
namespace {

constexpr int kMaxSplit = 8;     // the portable cluster size
constexpr int kMinSplitK = 128;  // k rows a split keeps at least

// Byte j of four int8 values (v already XORed with 0x80808080, i.e. each
// byte b stored as b + 128), as an exact float: the byte becomes the low
// mantissa bits of 2^23, and subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ float i8_at(uint32_t v_biased, int j) {
  return __uint_as_float(__byte_perm(v_biased, 0x4Bu, 0x4550u | j)) - 8388736.f;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// the K split: doubled while the grid is short of `want` blocks and each
// split would keep at least kMinSplitK rows
int split_count(int tiles, int K, int want, int min_k = kMinSplitK) {
  int s = 1;
  while (s < kMaxSplit && tiles * s < want && K >= 2 * s * min_k) s *= 2;
  return s;
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  if (grid.x == 1) {  // no K split: a plain launch (every block its own cluster of one)
    err = cudaLaunchKernelEx(&config, kernel, args...);
    const cudaError_t last1 = cudaGetLastError();
    return err != cudaSuccess ? err : last1;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;  // the K splits of one tile
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ---------------------------------------------------------------------------
// f32 x, and ragged shapes: scalar FMAs
// ---------------------------------------------------------------------------
constexpr int BM = 8;    // rows of a tile
constexpr int CG = 8;    // column groups a tile: lanes 0..7 of a warp
constexpr int BK = 512;  // k rows of x staged per chunk

constexpr int kCols = 4;              // columns per thread: one 4-byte int8 load
constexpr int kBN = CG * kCols;        // columns of a tile (32)
constexpr int kThreads = 256;             // threads
constexpr int kLanes = kThreads / CG;         // k-lanes per block (32)
constexpr int kWarps = kThreads / 32;         // warps
// x chunk [k][m] f32, one partial tile per warp, the block's partial tile
constexpr size_t kSimtSmem = sizeof(float) * (BK * BM + (kWarps + 1) * BM * kBN);

// VEC: the four columns as one 4-byte load (N % 4 == 0), else byte by byte
template <bool VEC>
__device__ __forceinline__ void load_w(const int8_t* __restrict__ w, int64_t row, int n, int N,
                                       float (&f)[kCols]) {
  if constexpr (!VEC) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) f[j] = n + j < N ? static_cast<float>(w[row + n + j]) : 0.f;
  } else if (n < N) {  // the columns are all in bounds or all out
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(w + row + n)) ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < kCols; ++j) f[j] = i8_at(v, j);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) f[j] = 0.f;
  }
}

// grid (splits, N tiles, M tiles), cluster (splits, 1, 1); split s sums
// k in [s * k_per_split, min(K, (s + 1) * k_per_split)).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scales, T* __restrict__ out, int M, int K, int N,
                   int k_per_split) {
  extern __shared__ __align__(16) float smem_f[];
  float* xs = smem_f;             // [BK][BM]
  float* red = xs + BK * BM;      // [kWarps][BM * kBN]
  float* part = red + kWarps * BM * kBN;  // [BM * kBN]

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;
  const int n0 = blockIdx.y * kBN, m0 = blockIdx.z * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col = (tid % CG) * kCols, kl = tid / CG;
  const int k_begin = blockIdx.x * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += BK) {
    const int kn = min(BK, k_end - kc);
    if (kc > k_begin) __syncthreads();  // the previous chunk has been read
    for (int i = tid; i < BM * kn; i += kThreads) {
      const int m = i / kn, k = i % kn;
      xs[k * BM + m] = m0 + m < M ? to_f32(x[static_cast<int64_t>(m0 + m) * K + kc + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = kl; k < kn; k += kLanes) {
      float wf[kCols];
      load_w<VEC>(w, static_cast<int64_t>(kc + k) * N, n0 + col, N, wf);
      const float4 xa = *reinterpret_cast<const float4*>(xs + k * BM);
      const float4 xb = *reinterpret_cast<const float4*>(xs + k * BM + 4);
      const float xv[BM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv[m], wf[j], acc[m][j]);
    }
  }

  // lanes 8 and 16 apart hold the same columns at other k-lanes
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < kCols; ++j) red[warp * BM * kBN + m * kBN + lane * kCols + j] = acc[m][j];
  }
  __syncthreads();
  for (int e = tid; e < BM * kBN; e += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += red[i * BM * kBN + e];
    part[e] = sum;
  }

  cluster.sync();  // every block of the cluster has its partial tile
  if (cluster.block_rank() == 0) {
    for (int e = tid; e < BM * kBN; e += kThreads) {
      // all the remote reads are in flight before the first sum waits for one
      float p[kMaxSplit];
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        p[r] = r < splits ? cluster.map_shared_rank(part, r)[e] : 0.f;
      float total = p[0];
#pragma unroll
      for (int r = 1; r < kMaxSplit; ++r) total += p[r];
      const int m = m0 + e / kBN, n = n0 + e % kBN;
      if (m < M && n < N) out[static_cast<int64_t>(m) * N + n] = from_f32<T>(total * scales[n]);
    }
  }
  cluster.sync();  // the peers' shared memory stays alive until rank 0 has read it
}

template <typename T, bool VEC>
cudaError_t launch_simt(const void* x, const void* w, const void* scales, void* out, int M, int K,
                        int N, cudaStream_t stream) {
  const int n_tiles = (N + kBN - 1) / kBN, m_tiles = (M + BM - 1) / BM;
  if (n_tiles > 65535 || m_tiles > 65535) return cudaErrorInvalidValue;
  const int splits = split_count(n_tiles * m_tiles, K, sm_count());
  const int k_per_split = (K + splits - 1) / splits;
  return launch_cluster(int8_matmul_kernel<T, VEC>, dim3(splits, n_tiles, m_tiles), kThreads,
                        kSimtSmem, stream, static_cast<const T*>(x),
                        static_cast<const int8_t*>(w), static_cast<const float*>(scales),
                        static_cast<T*>(out), M, K, N, k_per_split);
}

template <typename T>
cudaError_t dispatch_simt(const void* x, const void* w, const void* scales, void* out, int M,
                          int K, int N, cudaStream_t stream) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  return vec ? launch_simt<T, true>(x, w, scales, out, M, K, N, stream)
             : launch_simt<T, false>(x, w, scales, out, M, K, N, stream);
}

// ---------------------------------------------------------------------------
// bf16 x: the tensor-core route (per-warp mma.sync products)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NB, int CPT>
struct Mma {
  static constexpr int NW = NB <= 8 ? 16 : 8;   // warps a block, splitting K between them
  static constexpr int NT = 32 * NW;
  static constexpr int BNT = 8 * CPT;           // columns of a block's tile
  static constexpr int U = CPT == 16 ? 2 : 4;   // steps of weight loads in flight a warp
  static constexpr int KCH = 16384 / NB;        // k of x staged per chunk (32 KB)
  static constexpr int XS = KCH + 8;            // x row stride, bf16: conflict-free fragments
  static constexpr int RS = BNT + 4;            // partial-tile row stride, f32
  static constexpr int x_bytes = NB * XS * 2;         // one of the two x buffers
  static constexpr int red_bytes = NW * NB * RS * 4;  // one partial tile a warp
  static constexpr int part_bytes = NB * RS * 4;      // the block's partial tile
  static constexpr size_t smem = 2 * x_bytes + red_bytes + part_bytes;
};

template <int CPT>
struct WVec {
  uint32_t v[CPT / 4];
};

template <int CPT>
__device__ __forceinline__ WVec<CPT> load_wvec(const int8_t* __restrict__ p, bool in) {
  WVec<CPT> r;
  if constexpr (CPT == 16) {
    const uint4 u = in ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
    r.v[0] = u.x, r.v[1] = u.y, r.v[2] = u.z, r.v[3] = u.w;
  } else if constexpr (CPT == 8) {
    const uint2 u = in ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
    r.v[0] = u.x, r.v[1] = u.y;
  } else {
    r.v[0] = in ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
  }
  return r;
}

// grid (splits, N tiles, M tiles of 64), cluster (splits, 1, 1) when
// splits > 1; NB >= the rows of a tile (min(64, M - m0)); k_per_split a
// multiple of 16
template <int NB, int CPT>
__global__ void __launch_bounds__(Mma<NB, CPT>::NT)
int8_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scales, __nv_bfloat16* __restrict__ out, int M,
                       int K, int N, int k_per_split) {
  using L = Mma<NB, CPT>;
  constexpr int NW = L::NW, NT = L::NT, BNT = L::BNT, U = L::U, KCH = L::KCH, XS = L::XS,
                RS = L::RS, NJ = CPT / 2, MT = NB / 8;
  extern __shared__ __align__(16) uint8_t smem_mma[];
  __nv_bfloat16* const xbuf = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // 2 x [NB][XS]
  float* const red = reinterpret_cast<float*>(smem_mma + 2 * L::x_bytes);   // [NW][NB][RS]
  float* const part = red + NW * NB * RS;                                    // [NB][RS]

  const int splits = gridDim.x, rank = blockIdx.x;
  const int n0 = blockIdx.y * BNT, m0 = blockIdx.z * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int k_begin = rank * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  // this thread's CPT columns; its four k rows of a 16-row step: 2q, 2q + 1, 2q + 8, 2q + 9
  const int nt = n0 + g * CPT;
  const bool col_in = nt < N;  // N % CPT == 0: all in bounds or all out
  float acc[NJ][MT][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = 0.f;

  // x chunk c (rows m0 .., k from k_begin + c KCH, whole 16-row steps; rows
  // past M and k past k_end zeros) -> buffer c % 2, 16 bytes (8 k) a copy
  auto stage_x = [&](int c) {
    const int kc = k_begin + c * KCH;
    const int kn = min(KCH, k_end - kc), upr = 2 * ((kn + 15) / 16);
    const uint32_t dst = tc::smem_u32(xbuf + (c % 2) * NB * XS);
    for (int i = tid; i < NB * upr; i += NT) {
      const int m = i / upr, k8 = i % upr * 8;
      const bool in = m0 + m < M && k8 < kn;  // K % 8 == 0 and k_end % 8 == 0: whole or none
      tc::cp_async_16(dst + (m * XS + k8) * 2,
                      in ? x + static_cast<int64_t>(m0 + m) * K + kc + k8 : x, in ? 16 : 0);
    }
    tc::cp_async_commit();
  };
  const int n_chunks = k_end > k_begin ? (k_end - k_begin + KCH - 1) / KCH : 0;
  if (n_chunks > 0) stage_x(0);

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int kc = k_begin + ch * KCH;
    const int kn = min(KCH, k_end - kc), ns = (kn + 15) / 16;
    const __nv_bfloat16* const xs = xbuf + (ch % 2) * NB * XS;
    // this warp's first steps' weights are on their way before x has landed
    WVec<CPT> wv[U][4];
    auto load_group = [&](int s) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kc + 16 * (s + u * NW) + 2 * q + e % 2 + 8 * (e / 2);
          wv[u][e] = load_wvec<CPT>(w + static_cast<int64_t>(k) * N + nt,
                                    col_in && s + u * NW < ns && k < k_end);
        }
    };
    load_group(warp);
    tc::cp_async_wait<0>();  // this thread's copies of chunk ch
    __syncthreads();         // everyone's; and every warp is done with chunk ch - 1,
    if (ch + 1 < n_chunks) stage_x(ch + 1);  // whose buffer the next chunk's copies refill

    for (int s = warp; s < ns; s += NW * U) {
      if (s != warp) load_group(s);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int su = s + u * NW;  // uniform over the warp
        if (su >= ns) break;
        uint32_t b[MT][2];
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const __nv_bfloat16* xr = xs + (t * 8 + g) * XS + 16 * su + 2 * q;
          b[t][0] = *reinterpret_cast<const uint32_t*>(xr);
          b[t][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < CPT / 4; ++c) wv[u][e].v[c] ^= 0x80808080u;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          // rows g, g + 8 of the product are columns 2j, 2j + 1 of the thread's CPT
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c = 2 * j + r % 2, e = 2 * (r / 2);
            a[r] = tc::pack_bf16(i8_at(wv[u][e].v[c / 4], c % 4),
                                 i8_at(wv[u][e + 1].v[c / 4], c % 4));
          }
#pragma unroll
          for (int t = 0; t < MT; ++t) mma_m16n8k16(acc[j][t], a, b[t][0], b[t][1]);
        }
      }
    }
  }

  // acc[j][t]: c0, c1 = column nt + 2j of rows 8t + 2q, + 1; c2, c3 = column nt + 2j + 1
  float* const mine = red + warp * NB * RS;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine[(8 * t + 2 * q + i % 2) * RS + g * CPT + 2 * j + i / 2] = acc[j][t][i];
  __syncthreads();

  // the warps' partial tiles summed in warp order, four columns a thread
  const int rows = min(NB, M - m0);
  auto store = [&](int m, int c, float4 t) {
    const int n = n0 + c;
    const float4 sc = *reinterpret_cast<const float4*>(scales + n);
    const uint2 o = make_uint2(tc::pack_bf16(t.x * sc.x, t.y * sc.y),
                               tc::pack_bf16(t.z * sc.z, t.w * sc.w));
    *reinterpret_cast<uint2*>(out + static_cast<int64_t>(m0 + m) * N + n) = o;
  };
  for (int e = tid; e < NB * (BNT / 4); e += NT) {
    const int m = e / (BNT / 4), c = e % (BNT / 4) * 4;
    float4 p[NW];
#pragma unroll
    for (int r = 0; r < NW; ++r)
      p[r] = *reinterpret_cast<const float4*>(red + (r * NB + m) * RS + c);
    float4 t = p[0];
#pragma unroll
    for (int r = 1; r < NW; ++r) t.x += p[r].x, t.y += p[r].y, t.z += p[r].z, t.w += p[r].w;
    if (splits > 1) *reinterpret_cast<float4*>(part + m * RS + c) = t;
    else if (m < rows && n0 + c < N) store(m, c, t);
  }
  if (splits == 1) return;

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block of the cluster has its partial tile
  // each block sums a slice of the tile over all ranks, in rank order
  for (int e = rank * NT + tid; e < rows * (BNT / 4); e += splits * NT) {
    const int m = e / (BNT / 4), c = e % (BNT / 4) * 4;
    if (n0 + c >= N) continue;  // N % 4 == 0: the four columns are all in or all out
    // all the remote reads are in flight before the first sum waits for one
    float4 p[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      p[r] = r < splits ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) +
                                                           m * RS + c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 t = p[0];
#pragma unroll
    for (int r = 1; r < kMaxSplit; ++r) t.x += p[r].x, t.y += p[r].y, t.z += p[r].z, t.w += p[r].w;
    store(m, c, t);
  }
  cluster.sync();  // the peers' shared memory stays alive until every reader is done
}

constexpr int kMmaMinSplitK = 2048;  // k rows a split of the tensor-core route keeps at least

template <int NB, int CPT>
cudaError_t launch_mma(const void* x, const void* w, const void* scales, void* out, int M, int K,
                       int N, cudaStream_t stream) {
  using L = Mma<NB, CPT>;
  const int n_tiles = (N + L::BNT - 1) / L::BNT, m_tiles = (M + 63) / 64;
  if (n_tiles > 65535 || m_tiles > 65535) return cudaErrorInvalidValue;
  // K goes over a cluster only where the column tiles leave half the card
  // idle and each split keeps a long k range: a cluster launch costs about a
  // microsecond, and clusters of blocks this heavy fill a GPC badly
  const int splits = split_count(n_tiles * m_tiles, K, sm_count() / 2, kMmaMinSplitK);
  // whole 16-row steps a split, so a step never straddles two splits
  const int k_per_split = ((K + splits - 1) / splits + 15) / 16 * 16;
  return launch_cluster(int8_matmul_mma_kernel<NB, CPT>, dim3(splits, n_tiles, m_tiles), L::NT,
                        L::smem, stream, static_cast<const __nv_bfloat16*>(x),
                        static_cast<const int8_t*>(w), static_cast<const float*>(scales),
                        static_cast<__nv_bfloat16*>(out), M, K, N, k_per_split);
}

// the widest loads (16, 8 or 4 columns a thread) whose tiles still fill the card:
// at N = 32768 the 16-byte loads stream 2.23 TB/s against 1.68 for 4-byte ones,
// at N = 4096 only the 32-column tiles give every SM a block
template <int NB>
cudaError_t launch_mma_cols(const void* x, const void* w, const void* scales, void* out, int M,
                            int K, int N, cudaStream_t stream) {
  const int m_tiles = (M + 63) / 64, want = sm_count();
  if constexpr (NB <= 32)
    if ((N + 127) / 128 * m_tiles >= want)
      return launch_mma<NB, 16>(x, w, scales, out, M, K, N, stream);
  if ((N + 63) / 64 * m_tiles >= want)
    return launch_mma<NB, 8>(x, w, scales, out, M, K, N, stream);
  return launch_mma<NB, 4>(x, w, scales, out, M, K, N, stream);
}

cudaError_t dispatch_mma(const void* x, const void* w, const void* scales, void* out, int M, int K,
                         int N, cudaStream_t stream) {
  if (N % 16 || K % 8 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(scales) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return cudaErrorInvalidValue;
  if (M <= 8) return launch_mma_cols<8>(x, w, scales, out, M, K, N, stream);
  if (M <= 16) return launch_mma_cols<16>(x, w, scales, out, M, K, N, stream);
  if (M <= 32) return launch_mma_cols<32>(x, w, scales, out, M, K, N, stream);
  return launch_mma_cols<64>(x, w, scales, out, M, K, N, stream);
}

}  // namespace
}  // namespace rtt

extern "C" {

// x [M, K] (dtype: 0 f32, 1 bf16); w int8 [K, N]; scales f32 [N]; out [M, N]
// in x's dtype. All contiguous. M, N >= 1. route 0: scalar FMAs (either
// dtype, any shape); route 1: tensor cores (bf16 x, N % 16 == 0, K % 8 == 0,
// 16-byte aligned x, w and scales), refused otherwise.
int int8_matmul(const void* x, const void* w, const void* scales, void* out, int M, int K, int N,
                int x_dtype, int route, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 0) return cudaErrorInvalidValue;
  if (route == 1) {
    if (x_dtype != rtt::kBFloat16) return cudaErrorInvalidValue;
    return rtt::dispatch_mma(x, w, scales, out, M, K, N, s);
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (x_dtype == rtt::kFloat32) return rtt::dispatch_simt<float>(x, w, scales, out, M, K, N, s);
  if (x_dtype == rtt::kBFloat16)
    return rtt::dispatch_simt<__nv_bfloat16>(x, w, scales, out, M, K, N, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
