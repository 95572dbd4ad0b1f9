// Blockwise FlashAttention forward: out and per-row logsumexp.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_attn_fwd_kernel (driver
// _flash_forward), reached by flash_attention, flash_attention_with_lse and
// sliding_window_attention. Causal, non-causal or sliding-window
// (key k visible to query q iff k > q - window). Two routes, chosen by dtype
// and head dimension only (D = 64 or 128):
//
// bf16 -> flash_fwd_wgmma_kernel, on the tensor cores. Every user-facing
// path is bf16 (the engine's dense-cache prefill, the train step). At the
// train shape (B*H = 96, T = 2048, D = 128, causal) the kernel is bound by
// operations: 4 FLOPs per visible (q, k) pair per head dimension, 0.104 ms
// at the 989 bf16 TFLOP/s that only wgmma reaches. Design:
//   * one block per (b*h, 192-row q-tile): three warpgroups of 64 rows (one
//     warpgroup when Tq <= 64, as at the serving prefill); causal q-tiles
//     are dispatched longest first, every head's before any shorter one;
//   * Q and a ring of 3 K/V stages of 64 keys in shared memory, filled by
//     16-byte cp.async in the 128-byte swizzle the wgmma descriptors read
//     (wgmma.cuh): the copies of tile j + 1 run under the products of tile
//     j, and three stages need one barrier a tile. Rows past Tq / Tk are
//     zero-filled, never padded in memory;
//   * S = Q.K^T: wgmma m64n64k16, Q and K from shared memory (D contracted,
//     contiguous in both). The f32 accumulator is scaled (scale * log2 e) in
//     f32 -- never Q in bf16, which would move lse past its 1e-4 limit. Any
//     scale is taken: a negative one flips Q's sign bits in shared memory
//     (exact), so the row max is always taken on the raw scores;
//   * online softmax in f32 registers, row max and sum across the 4 lanes
//     that share an accumulator row. It, not the products, sets the pace
//     (measured: without it the kernel takes half the time), and it is
//     bound by latency, so each weight is one FFMA and one MUFU.EX2, the
//     row reductions run as four independent chains, and a third
//     warpgroup gives each scheduler three warps to switch between;
//   * O += P.V: P rounded to bf16 in registers is the A operand as it
//     stands (the accumulator and A-operand layouts line up), V the
//     transposed (MN-major) B operand from shared memory. The TPU kernel
//     also ran this product from bf16 operands on its MXU;
//   * tiles above the causal diagonal or wholly outside the window are never
//     loaded; the mask is applied only on tiles that straddle the diagonal,
//     the window edge or Tk. A row that sees no key writes zeros and
//     lse = -1e30, as the TPU kernel's l == 0 guard does.
// Shared memory (three warpgroups): 73 KB at D = 64, 145 KB at D = 128.
// Registers: 152 at D = 128, 111 at D = 64, no spills (ptxas -v).
//
// f32 -> flash_fwd_kernel, scalar FMAs: kept only for the f32 parity checks,
// whose limits (atol 1e-4) rule out TF32. One block per (b*h, 32-row q-tile),
// 128 threads, 4 per query row, 32-key f32 tiles in shared memory (~29 KB at
// D = 64, ~54 KB at D = 128), the same tile skipping and edge rules.
#include <cfloat>

#include "common.cuh"
#include "wgmma.cuh"

namespace rtt {
namespace {

constexpr int kBQ = 32, kBK = 32, kThreads = 128;
constexpr int kTPR = kThreads / kBQ;  // threads per query row
constexpr int kCPT = kBK / kTPR;      // score columns per thread

template <int D>
size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int Tq, int Tk, float scale, int causal, int window) {
  constexpr int DPT = D / kTPR;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BQ][D+1], pre-scaled
  float* k_s = q_s + kBQ * (D + 1);  // [BK][D+1]
  float* v_s = k_s + kBK * (D + 1);  // [BK][D]
  float* p_s = v_s + kBK * D;        // [BQ][BK+1]

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, row = tid / kTPR, sub = tid % kTPR;
  const int qpos = q0 + row;
  const int64_t q_base = static_cast<int64_t>(bh) * Tq * D;
  const int64_t k_base = static_cast<int64_t>(bh) * Tk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[r * (D + 1) + d] =
        q0 + r < Tq ? q[q_base + static_cast<int64_t>(q0 + r) * D + d] * scale : 0.f;
  }

  // keys that can be visible to some row of this tile
  int k_end = Tk;
  if (causal) k_end = min(k_end, q0 + kBQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBK * kBK;

  float m = -INFINITY, l = 0.f, acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, Tk - k0);
    __syncthreads();  // the previous tile's readers are done (and q_s is written)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        const int64_t src = k_base + static_cast<int64_t>(k0 + j) * D + d;
        kx = k[src];
        vx = v[src];
      }
      k_s[j * (D + 1) + d] = kx;
      v_s[j * D + d] = vx;
    }
    __syncthreads();

    float s[kCPT];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      const int j = sub + c * kTPR, kpos = k0 + j;
      const bool visible = j < nk && qpos < Tq && (!causal || kpos <= qpos) &&
                           (window <= 0 || kpos > qpos - window);
      float x = -INFINITY;
      if (visible) {
        const float* qr = q_s + row * (D + 1);
        const float* kj = k_s + j * (D + 1);
        x = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) x += qr[d] * kj[d];
      }
      s[c] = x;
      mx = fmaxf(mx, x);
    }
    // the kTPR threads of a row are neighbouring lanes of one warp
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    float alpha = 1.f, sum = 0.f;
    if (m_new != -INFINITY) {  // else: nothing visible to this row yet
      alpha = m == -INFINITY ? 0.f : expf(m - m_new);
#pragma unroll
      for (int c = 0; c < kCPT; ++c) {
        s[c] = s[c] == -INFINITY ? 0.f : expf(s[c] - m_new);
        sum += s[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < kCPT; ++c) s[c] = 0.f;
    }
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kCPT; ++c) p_s[row * (kBK + 1) + sub + c * kTPR] = s[c];
    __syncwarp();

    const float* pr = p_s + row * (kBK + 1);
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * kTPR;
      float a = acc[i] * alpha;
      for (int j = 0; j < nk; ++j) a += pr[j] * v_s[j * D + d];
      acc[i] = a;
    }
  }

  if (qpos < Tq) {
    const int64_t o_base = q_base + static_cast<int64_t>(qpos) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      out[o_base + sub + i * kTPR] = l == 0.f ? 0.f : acc[i] / l;
    }
    if (sub == 0) lse[static_cast<int64_t>(bh) * Tq + qpos] = l == 0.f ? kNegInf : m + logf(l);
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                        int Tq, int Tk, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tq + kBQ - 1) / kBQ, BH), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), Tq, Tk, scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core route
// ---------------------------------------------------------------------------
constexpr int kTileKeys = 64;  // keys a K/V tile (the N of S = Q.K^T)
constexpr int kStages = 3;     // K/V tiles in flight: one barrier a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D, int NWG>
struct FwdTiles {
  static constexpr int BM = 64 * NWG;                // q rows a block
  static constexpr int q_bytes = BM * D * 2;         // swizzled Q tile
  static constexpr int kv_bytes = kTileKeys * D * 2;  // one K or V tile
  static constexpr int stage_bytes = 2 * kv_bytes;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t smem = q_bytes + kStages * stage_bytes + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Tq, int Tk, float scale, int causal,
                       int window) {
  using L = FwdTiles<D, NWG>;
  constexpr int BM = L::BM, NT = 128 * NWG, BK = kTileKeys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + L::q_bytes;  // stage st: K at + st * stage_bytes, V after it

  // causal q-tiles run longest first, every head's before any shorter one
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int64_t q_base = static_cast<int64_t>(bh) * Tq * D;
  const int64_t k_base = static_cast<int64_t>(bh) * Tk * D;

  // keys that can be visible to some row of this tile
  int k_end = Tk;
  if (causal) k_end = min(k_end, q0 + BM);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  tc::load_tile<BM, D, NT>(q_s, q + q_base, q0, Tq);
  if (n_tiles > 0) {
    tc::load_tile<BK, D, NT>(kv_s, k + k_base, k_begin, Tk);
    tc::load_tile<BK, D, NT>(kv_s + L::kv_bytes, v + k_base, k_begin, Tk);
  }
  tc::cp_async_commit();

  // Scores enter the softmax as s * sl2 (log2 units), and each row's max is
  // taken on the raw s, which picks the max of the products only for sl2 > 0.
  // A negative scale flips the sign of Q in shared memory instead (exact in
  // bf16: s becomes -s); a zero scale becomes the least normal float, which
  // leaves every visible weight 2^(s * 2^-126 - m) exactly 1 and a masked one 0.
  float sl2 = scale * kLog2e;
  if (sl2 < 0.f) {  // the same for every thread of the grid
    tc::cp_async_wait<0>();
    __syncthreads();
    uint4* qw = reinterpret_cast<uint4*>(smem_raw + (q_s - tc::smem_u32(smem_raw)));
    for (int i = threadIdx.x; i < L::q_bytes / 16; i += NT) {
      uint4 x = qw[i];
      x.x ^= 0x80008000u, x.y ^= 0x80008000u, x.z ^= 0x80008000u, x.w ^= 0x80008000u;
      qw[i] = x;
    }
    sl2 = -sl2;  // the loop's fence.proxy.async and barrier publish Q to wgmma
  }
  if (sl2 == 0.f) sl2 = FLT_MIN;

  // this warpgroup's 64 rows start at r0; this thread holds rows ra, ra + 8
  const int r0 = q0 + wg * 64;
  const int ra = r0 + warp * 16 + lane / 4;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns only

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    const uint32_t k_s = kv_s + (it % kStages) * L::stage_bytes, v_s = k_s + L::kv_bytes;
    // the stage refilled here was last read in tile it - 2, and every
    // thread is past it: the barrier below, in tile it - 1, came after it
    if (it + 1 < n_tiles) {
      const uint32_t nk = kv_s + ((it + 1) % kStages) * L::stage_bytes;
      tc::load_tile<BK, D, NT>(nk, k + k_base, k0 + BK, Tk);
      tc::load_tile<BK, D, NT>(nk + L::kv_bytes, v + k_base, k0 + BK, Tk);
    }
    tc::cp_async_commit();  // possibly empty: one group a tile either way
    tc::cp_async_wait<1>();  // this tile (and Q) have landed
    tc::fence_proxy_async();
    __syncthreads();

    // a warpgroup with no visible pair in this tile skips it
    if (r0 >= Tq || (causal && k0 > r0 + 63) || (window > 0 && k0 + BK - 1 <= r0 - window))
      continue;

    float s[BK / 2];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss_n64(s, tc::desc_k<BM>(q_s, wg * 64, kk), tc::desc_k<BK>(k_s, 0, kk), kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::pin(s);

    const bool edge = (causal && k0 + BK - 1 > r0) || (window > 0 && k0 <= r0 + 63 - window) ||
                      k0 + BK > Tk;
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int row = ra + 8 * ((i / 2) % 2);
        const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + i % 2;
        if (!(col < Tk && (!causal || col <= row) && (window <= 0 || col > row - window)))
          s[i] = -INFINITY;
      }
    }
    // Online softmax, the latency-bound part of the loop (see the top):
    // p = 2^(s * sl2 - m), one FFMA and one MUFU.EX2 a weight, m the running
    // row max in the same log2 units (sl2 > 0, so the max of the raw scores
    // picks it); the row reductions run as four chains.
    float alpha[2], base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)  // row h holds s[4c + 2h], s[4c + 2h + 1]
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[c % 2 * 2 + e] = fmaxf(part[c % 2 * 2 + e], s[4 * c + 2 * h + e]);
      float mx = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * sl2);
      base[h] = m_new == -INFINITY ? 0.f : m_new;  // nothing visible yet: p = 0, not NaN
      alpha[h] = tc::ex2(m[h] - base[h]);
      m[h] = m_new;
    }
    float sum[2][4] = {};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) % 2;
      s[i] = tc::ex2(fmaf(s[i], sl2, -base[h]));
      sum[h][i / 4 % 2 * 2 + i % 2] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = l[h] * alpha[h] + ((sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    uint32_t p[BK / 16][4];
    tc::to_a_operand(s, p);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) tc::mma_rs<D>(o, p[kk], tc::desc_mn<BK>(v_s, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::pin(o);
    tc::pin(p);
  }

  if (r0 >= Tq) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (row >= Tq) continue;
    const float inv = sum == 0.f ? 0.f : 1.f / sum;
    __nv_bfloat16* orow = out + q_base + static_cast<int64_t>(row) * D + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
    if (lane % 4 == 0)
      lse[static_cast<int64_t>(bh) * Tq + row] = sum == 0.f ? kNegInf : m[h] * kLn2 + logf(sum);
  }
}

template <int D, int NWG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                         int BH, int Tq, int Tk, float scale, int causal, int window,
                         cudaStream_t stream) {
  constexpr size_t smem = FwdTiles<D, NWG>::smem;
  auto kernel = flash_fwd_wgmma_kernel<D, NWG>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int BM = FwdTiles<D, NWG>::BM;
  kernel<<<dim3(BH, (Tq + BM - 1) / BM), 128 * NWG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Tq, Tk, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                        int Tq, int Tk, float scale, int causal, int window, cudaStream_t s) {
  if (Tq <= 64)
    return launch_wgmma<D, 1>(q, k, v, out, lse, BH, Tq, Tk, scale, causal, window, s);
  return launch_wgmma<D, 3>(q, k, v, out, lse, BH, Tq, Tk, scale, causal, window, s);
}

}  // namespace
}  // namespace rtt

extern "C" {

// q [BH, Tq, D]; k/v [BH, Tk, D]; out [BH, Tq, D] in q's dtype; lse f32
// [BH, Tq]. All contiguous (bf16: 16-byte aligned). window <= 0 means no
// window. bf16 runs the tensor-core kernel, f32 the scalar one.
int flash_attention_forward(const void* q, const void* k, const void* v, void* out, void* lse,
                            int BH, int Tq, int Tk, int D, int dtype, float scale, int causal,
                            int window, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using rtt::kBFloat16;
  using rtt::kFloat32;
  if (dtype == kBFloat16 && D == 64)
    return rtt::launch_bf16<64>(q, k, v, out, lse, BH, Tq, Tk, scale, causal, window, s);
  if (dtype == kBFloat16 && D == 128)
    return rtt::launch_bf16<128>(q, k, v, out, lse, BH, Tq, Tk, scale, causal, window, s);
  if (dtype == kFloat32 && D == 64)
    return rtt::launch_simt<64>(q, k, v, out, lse, BH, Tq, Tk, scale, causal, window, s);
  if (dtype == kFloat32 && D == 128)
    return rtt::launch_simt<128>(q, k, v, out, lse, BH, Tq, Tk, scale, causal, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
