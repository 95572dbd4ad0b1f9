// Int8 weight-only matrix product (W8A16):
//   out[M, N] = (x[M, K] @ w[K, N]) * scales[N]
// with x in f32 or bf16, w int8 (N contiguous, the JAX layout), scales f32
// per output column, the sum in f32, and out in x's dtype.
//
// Replaces the TPU kernel of ray_tpu/ops/quantization.py:
//   int8_matmul  <- _int8_matmul_kernel (grid (M/bm, N/bn, K/bk), K innermost,
//                   an f32 VMEM accumulator, the scale applied on the last k-step)
//
// What bounds it on the H100: bytes. At the serving path's decode shapes
// (M = 8 rows, K = 1024 or 4096, N = 512 to 4096) every weight byte meets
// only M rows, 2 * M FLOPs per byte, far under the ~295 FLOP/byte ridge; the
// kernel's job is to stream the int8 weights from HBM once, at full rate.
// Design against that:
//   * a block owns BN = 32 output columns of BM = 8 rows. Each thread owns 4
//     adjacent columns and reads them as one 4-byte load per k row, so a
//     warp reads 4 rows x 32 contiguous bytes (whole 32-byte sectors). The
//     weights go straight from global memory into registers and are
//     converted there (PRMT + FADD, no I2F); no dequantized copy is ever
//     stored. The 32 k-lanes of a block stride over K; x is staged through
//     shared memory in f32, 256 k rows at a time, and read back as float4s.
//   * Decode grids are small (N / 32 column tiles: 16 at N = 512), so K is
//     split over a thread-block cluster of up to 8 blocks (gridDim.x), chosen
//     so the grid covers the 132 SMs: 128 blocks at N = 512, 256 at
//     N = 1024 and N = 4096 (the M = 8 decode shapes). Each block reduces its
//     k-lanes (warp shuffles, then shared memory); rank 0 of the cluster adds
//     the peers' partial tiles through distributed shared memory in rank
//     order, scales, rounds and stores. No atomics and no scratch in global
//     memory: a launch is bitwise repeatable.
//   * Ragged M, N and K are masked, not padded. The 4-byte loads need
//     N % 4 == 0 and an aligned base; otherwise a scalar variant loads byte
//     by byte.
// Weights are read once per 8-row tile: a prefill of M rows reads them M / 8
// times, mostly from L2. Not yet done (ROADMAP, "make K6 fast"): tensor-core
// tiles (int8 -> bf16 in registers feeding mma/wgmma), TMA staging and
// deeper pipelining of the weight stream.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace rtt {
namespace {

constexpr int kThreads = 256;
constexpr int BM = 8;                // rows of a tile
constexpr int BN = 32;               // columns of a tile
constexpr int CPT = 4;               // columns per thread: one 4-byte int8 load
constexpr int CG = BN / CPT;         // column groups per tile (8)
constexpr int KL = kThreads / CG;    // k-lanes per block (32)
constexpr int BK = 256;              // k rows of x staged per chunk
constexpr int kMaxSplit = 8;         // the portable cluster size
constexpr int kMinSplitK = 128;      // k rows a split keeps at least
static_assert(BM * BN == kThreads, "one output of the tile per thread in the epilogue");
static_assert(KL % 4 == 0 && CG == 8, "the shuffle reduction assumes 4 k-lanes per warp");

// Byte J of four int8 values (v already XORed with 0x80808080, i.e. each
// byte b stored as b + 128), as an exact float: the byte becomes the low
// mantissa bits of 2^23, and subtracting 2^23 + 128 leaves b.
template <int J>
__device__ __forceinline__ float i8_at(uint32_t v_biased) {
  return __uint_as_float(__byte_perm(v_biased, 0x4Bu, 0x4550u | J)) - 8388736.f;
}

template <bool VEC>
__device__ __forceinline__ void load_w(const int8_t* __restrict__ w, int64_t row, int n, int N,
                                       float f[CPT]) {
  if (VEC) {  // N % 4 == 0: the 4 columns are all in bounds or all out
    if (n < N) {
      const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(w + row + n)) ^ 0x80808080u;
      f[0] = i8_at<0>(v);
      f[1] = i8_at<1>(v);
      f[2] = i8_at<2>(v);
      f[3] = i8_at<3>(v);
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j) f[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) f[j] = n + j < N ? static_cast<float>(w[row + n + j]) : 0.f;
  }
}

// grid (splits, N tiles, M tiles), cluster (splits, 1, 1); split s sums
// k in [s * k_per_split, min(K, (s + 1) * k_per_split)).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scales, T* __restrict__ out, int M, int K, int N,
                   int k_per_split) {
  __shared__ __align__(16) float xs[BK * BM];   // x chunk in f32, [k][m]
  __shared__ float red[kThreads / 32][BM * BN];  // one partial tile per warp
  __shared__ float part[BM * BN];                // this block's partial tile

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col = (tid % CG) * CPT, kl = tid / CG;
  const int k_begin = blockIdx.x * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[BM][CPT];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += BK) {
    const int kn = min(BK, k_end - kc);
    __syncthreads();  // the previous chunk has been read
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = i / BK, k = i % BK;
      xs[k * BM + m] =
          (m0 + m < M && k < kn) ? to_f32(x[static_cast<int64_t>(m0 + m) * K + kc + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = kl; k < kn; k += KL) {
      float wf[CPT];
      load_w<VEC>(w, static_cast<int64_t>(kc + k) * N, n0 + col, N, wf);
      const float4 xa = *reinterpret_cast<const float4*>(xs + k * BM);
      const float4 xb = *reinterpret_cast<const float4*>(xs + k * BM + 4);
      const float xv[BM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[m][j] = fmaf(xv[m], wf[j], acc[m][j]);
    }
  }

  // lanes 8 and 16 apart hold the same columns at other k-lanes
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < CPT; ++j) red[warp][m * BN + lane * CPT + j] = acc[m][j];
  }
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) sum += red[i][tid];
  part[tid] = sum;

  cluster.sync();  // every block of the cluster has its partial tile
  if (cluster.block_rank() == 0) {
    float total = 0.f;
    for (int r = 0; r < splits; ++r) total += cluster.map_shared_rank(part, r)[tid];
    const int m = m0 + tid / BN, n = n0 + tid % BN;
    if (m < M && n < N) out[static_cast<int64_t>(m) * N + n] = from_f32<T>(total * scales[n]);
  }
  cluster.sync();  // the peers' shared memory stays alive until rank 0 has read it
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

// the K split: doubled while the grid is short of one block per SM and each
// split would keep at least kMinSplitK rows
int split_count(int tiles, int K) {
  int s = 1;
  while (s < kMaxSplit && tiles * s < sm_count() && K >= 2 * s * kMinSplitK) s *= 2;
  return s;
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* w, const void* scales, void* out, int M, int K,
                   int N, cudaStream_t stream) {
  const int n_tiles = (N + BN - 1) / BN, m_tiles = (M + BM - 1) / BM;
  if (n_tiles > 65535 || m_tiles > 65535) return cudaErrorInvalidValue;
  const int splits = split_count(n_tiles * m_tiles, K);
  const int k_per_split = (K + splits - 1) / splits;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, n_tiles, m_tiles);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, int8_matmul_kernel<T, VEC>, static_cast<const T*>(x),
      static_cast<const int8_t*>(w), static_cast<const float*>(scales), static_cast<T*>(out), M,
      K, N, k_per_split);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t dispatch_vec(const void* x, const void* w, const void* scales, void* out, int M,
                         int K, int N, cudaStream_t stream) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  return vec ? launch<T, true>(x, w, scales, out, M, K, N, stream)
             : launch<T, false>(x, w, scales, out, M, K, N, stream);
}

}  // namespace
}  // namespace rtt

extern "C" {

// x [M, K] (dtype: 0 f32, 1 bf16); w int8 [K, N]; scales f32 [N]; out [M, N]
// in x's dtype. All contiguous. M, N >= 1.
int int8_matmul(const void* x, const void* w, const void* scales, void* out, int M, int K, int N,
                int x_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 0) return cudaErrorInvalidValue;
  if (x_dtype == rtt::kFloat32) return rtt::dispatch_vec<float>(x, w, scales, out, M, K, N, s);
  if (x_dtype == rtt::kBFloat16)
    return rtt::dispatch_vec<__nv_bfloat16>(x, w, scales, out, M, K, N, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
