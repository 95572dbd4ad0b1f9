// Blockwise FlashAttention backward (FlashAttention-2 split, no atomics):
//
//   flash_attention_backward_dq   dq = scale * sum_k P o (dP - delta) . K
//     replaces ray_tpu/ops/attention.py::_bwd_dq_kernel (K4);
//   flash_attention_backward_dkv  dv = sum_q P^T . dO,
//                                 dk = scale * sum_q (P o (dP - delta))^T . Q
//     replaces ray_tpu/ops/attention.py::_bwd_dkv_kernel (K5);
//
// both reached through the JAX wrapper _flash_backward and the custom VJP of
// flash_attention_with_lse. P = exp(q.k * scale - lse) is recomputed from the
// forward's saved lse; delta = rowsum(dO o O) - g_lse comes from the caller
// (plain PyTorch, as the JAX wrapper computes it in plain XLA), so the lse
// cotangent folds into the same term. Causal, non-causal or sliding window
// (key k visible to query q iff k > q - window), as the forward kernel.
//
// What bounds them on the H100: at the training shape (B*H = 96, T = 2048,
// D = 128, causal) both are bound by operations (6 and 8 FLOPs per visible
// (q, k) pair per head dimension): 0.156 and 0.209 ms a call at the tensor
// cores' 989 TFLOP/s. Each block owns its outputs -- dq a q-tile, dk/dv a
// k-tile -- accumulates in f32 registers and writes its own rows once, in a
// fixed order: no atomics, so a launch is bitwise repeatable (bit-exact
// resume needs that). P is SELECTED by the mask, never multiplied by it: a
// row that sees no key has lse = -1e30, and exp(s - lse) = inf would turn
// 0 * inf into NaN. Tiles that hold no visible pair are never loaded (above
// the causal diagonal, left of the window, and for dk/dv past q + window);
// rows past Tq / Tk are zero-filled and never written, instead of padding
// the inputs as the JAX wrapper does.
//
// dk/dv, bf16 -> flash_bwd_dkv_wgmma_kernel, on the tensor cores:
//   * one block per (b*h, 128-key tile): two warpgroups of 64 keys; K and V
//     stay in shared memory, dK and dV accumulate in f32 registers (64 + 64
//     a thread at D = 128); key tiles dispatched longest first (causal);
//   * the block walks the 64-query tiles that can see its keys; Q, dO, lse
//     and delta of tile j + 1 are copied (cp.async, 128-byte swizzle) into
//     the next of three stages while tile j computes (three stages need one
//     barrier a tile);
//   * per q-tile, four wgmma products: S^T = K.Q^T and dP^T = V.dO^T
//     (m64n64k16, both operands in shared memory, D contracted), then
//     P^T = 2^(S^T * scale * log2 e - lse * log2 e) (one FFMA and one
//     MUFU.EX2 a weight) selected by the mask,
//     dS^T = P^T o (dP^T - delta) with lse and delta per column from shared
//     memory, then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T rounded
//     to bf16 as register A operands and dO, Q as transposed (MN-major) B
//     operands. The TPU kernel ran the same products from bf16 operands.
//     The products go in three commit groups, so P^T is formed while dP^T
//     is still on the tensor cores and dS^T while dV is;
//   * dK is scaled by `scale` once, at the end.
//   Registers: dK + dV 128, S^T + dP^T 64 at their peak: 250 at D = 128,
//   181 at D = 64, no spills (ptxas -v in the build log). Shared memory: K, V 2 x 32 KB,
//   three stages of Q, dO 3 x 32 KB, lse and delta 1.5 KB: ~163 KB at
//   D = 128, ~83 KB at D = 64.
// dk/dv, f32 -> flash_bwd_dkv_kernel: scalar FMAs, kept only for the f32
//   parity checks (their 1e-3 gradient limits rule out TF32): 32-key tiles,
//   128 threads, 4 per key row, f32 tiles of q, dO, k, v, P and dS (~42 KB
//   at D = 64, ~75 KB at D = 128).
// dq, bf16 -> flash_bwd_dq_wgmma_kernel, on the tensor cores: K5's design
// with the roles of queries and keys exchanged:
//   * one block per (b*h, 128-row q-tile): two warpgroups of 64 rows. Q and
//     dO stay in shared memory, each thread's two rows of lse (in log2
//     units) and delta in registers, dQ accumulates in f32 registers (64 a
//     thread at D = 128); causal q-tiles dispatched longest first;
//   * the block walks the 64-key tiles its rows can see; K and V of tile
//     j + 1 are copied (cp.async, 128-byte swizzle) while tile j computes:
//     four stages and one barrier a tile (four, because dQ's product is
//     still reading its K tile when the next tile begins);
//   * per key tile, three wgmma products: S = Q.K^T and dP = dO.V^T
//     (m64n64k16, both operands in shared memory, D contracted), then
//     P = 2^(S * scale * log2 e - lse * log2 e) selected by the mask (one
//     FFMA and one MUFU.EX2 a weight), dS = P o (dP - delta), and
//     dQ += dS.K with dS rounded to bf16 as the register A operand and the
//     same K tile read down its rows as the transposed (MN-major) B operand:
//     no shared-memory round trip for dS, no second copy of K. Three commit
//     groups: P forms while dP is on the tensor cores, and the dQ product
//     is left running under the next tile's barrier and first products
//     (0.505 -> 0.481 ms); three warpgroups (168 registers) were slower
//     (0.54), one far slower (0.81);
//   * dQ is scaled by `scale` once, at the end; rows past Tq are never
//     written.
//   Registers: 180 at D = 128, 138 at D = 64 at the first build, no spills
//   (ptxas -v in the build log). Shared memory: Q, dO 2 x 32 KB, four stages
//   of K, V 4 x 32 KB: ~193 KB at D = 128, ~97 KB at D = 64. At the train
//   shape it takes 0.48 ms against 0.156 of bound: like K5, what is left is
//   the exponentials and the waits between dependent products, not the
//   tensor cores' rate.
// dq, f32 -> flash_bwd_dq_kernel: scalar FMAs, kept only for the f32 parity
//   checks: one block per 32-row q-tile walking the k-tiles it can see,
//   f32 tiles of q, dO, k, v and dS (~37 / ~70 KB).
#include "common.cuh"
#include "wgmma.cuh"

namespace rtt {
namespace {

constexpr int kB = 32, kThreads = 128;  // 32-row q and k tiles
constexpr int kTPR = kThreads / kB;     // threads per tile row
constexpr int kCPT = kB / kTPR;         // score columns per thread

template <int D>
size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + 1) + kB * (kB + 1));
}

template <int D>
size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

// rows [r0, r0 + kB) of a [rows, D] matrix into a [kB][D+1] f32 tile;
// rows >= n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int64_t base,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r0 + r < n ? to_f32(src[base + static_cast<int64_t>(r0 + r) * D + d])
                                      : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Tq, int Tk, float scale, int causal,
                    int window) {
  constexpr int DPT = D / kTPR;  // dq columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                // [B][D+1]
  float* do_s = q_s + kB * (D + 1);  // [B][D+1]
  float* k_s = do_s + kB * (D + 1);  // [B][D+1]
  float* v_s = k_s + kB * (D + 1);   // [B][D+1]
  float* ds_s = v_s + kB * (D + 1);  // [B][B+1]

  const int bh = blockIdx.y, q0 = blockIdx.x * kB;
  const int tid = threadIdx.x, row = tid / kTPR, sub = tid % kTPR;
  const int qpos = q0 + row;
  const bool row_in = qpos < Tq;
  const int64_t q_base = static_cast<int64_t>(bh) * Tq * D;
  const int64_t k_base = static_cast<int64_t>(bh) * Tk * D;
  const float row_lse = row_in ? lse[static_cast<int64_t>(bh) * Tq + qpos] : 0.f;
  const float row_delta = row_in ? delta[static_cast<int64_t>(bh) * Tq + qpos] : 0.f;

  load_tile<float, D>(q_s, q, q_base, q0, Tq);
  load_tile<float, D>(do_s, dout, q_base, q0, Tq);

  // keys that can be visible to some row of this tile
  int k_end = Tk;
  if (causal) k_end = min(k_end, q0 + kB);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kB * kB;

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  const float* qr = q_s + row * (D + 1);
  const float* dr = do_s + row * (D + 1);
  for (int k0 = k_begin; k0 < k_end; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done (and q/dO are written)
    load_tile<float, D>(k_s, k, k_base, k0, Tk);
    load_tile<float, D>(v_s, v, k_base, k0, Tk);
    __syncthreads();

    float s[kCPT], dp[kCPT];
#pragma unroll
    for (int c = 0; c < kCPT; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], dd = dr[d];
#pragma unroll
      for (int c = 0; c < kCPT; ++c) {
        const int j = sub + c * kTPR;
        s[c] += qd * k_s[j * (D + 1) + d];
        dp[c] += dd * v_s[j * (D + 1) + d];
      }
    }
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      const int j = sub + c * kTPR, kpos = k0 + j;
      const bool vis = row_in && kpos < Tk && visible(qpos, kpos, causal, window);
      const float p = vis ? expf(s[c] * scale - row_lse) : 0.f;
      ds_s[row * (kB + 1) + j] = p * (dp[c] - row_delta);
    }
    __syncwarp();  // a row's dS is written and read by the same 4 lanes

    // dq += dS . K (keys past Tk have dS = 0 and a zero-filled K row)
    const float* dsr = ds_s + row * (kB + 1);
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      const float x = dsr[j];
      const float* kj = k_s + j * (D + 1);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += x * kj[sub + i * kTPR];
    }
  }

  if (row_in) {
    const int64_t o = q_base + static_cast<int64_t>(qpos) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dq[o + sub + i * kTPR] = acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, float scale,
                     int causal, int window) {
  constexpr int DPT = D / kTPR;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;                  // [B][D+1] this block's keys
  float* v_s = k_s + kB * (D + 1);     // [B][D+1]
  float* q_s = v_s + kB * (D + 1);     // [B][D+1] the current q-tile
  float* do_s = q_s + kB * (D + 1);    // [B][D+1]
  float* p_s = do_s + kB * (D + 1);    // [B keys][B+1 queries]
  float* ds_s = p_s + kB * (kB + 1);   // [B keys][B+1 queries]
  float* lse_s = ds_s + kB * (kB + 1);  // [B]
  float* dl_s = lse_s + kB;            // [B] delta

  const int bh = blockIdx.y, k0 = blockIdx.x * kB;
  const int tid = threadIdx.x, row = tid / kTPR, sub = tid % kTPR;
  const int kpos = k0 + row;
  const int64_t q_base = static_cast<int64_t>(bh) * Tq * D;
  const int64_t k_base = static_cast<int64_t>(bh) * Tk * D;

  load_tile<float, D>(k_s, k, k_base, k0, Tk);
  load_tile<float, D>(v_s, v, k_base, k0, Tk);

  // queries that can see some key of this tile: causal needs q >= k0; the
  // window needs q < k + window, at most k0 + kB - 1 + window - 1
  int q_begin = causal ? k0 / kB * kB : 0;
  int q_end = Tq;
  if (window > 0) q_end = min(q_end, k0 + kB - 1 + window);

  float acc_k[DPT], acc_v[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  const float* kr = k_s + row * (D + 1);
  const float* vr = v_s + row * (D + 1);
  for (int q0 = q_begin; q0 < q_end; q0 += kB) {
    __syncthreads();  // the previous tile's readers are done (and k/v are written)
    load_tile<float, D>(q_s, q, q_base, q0, Tq);
    load_tile<float, D>(do_s, dout, q_base, q0, Tq);
    if (tid < kB) {
      const bool in = q0 + tid < Tq;
      const int64_t r = static_cast<int64_t>(bh) * Tq + q0 + tid;
      lse_s[tid] = in ? lse[r] : 0.f;
      dl_s[tid] = in ? delta[r] : 0.f;
    }
    __syncthreads();

    float s[kCPT], dp[kCPT];
#pragma unroll
    for (int c = 0; c < kCPT; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int c = 0; c < kCPT; ++c) {
        const int i = sub + c * kTPR;
        s[c] += kd * q_s[i * (D + 1) + d];
        dp[c] += vd * do_s[i * (D + 1) + d];
      }
    }
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      const int i = sub + c * kTPR, qpos = q0 + i;
      const bool vis = qpos < Tq && kpos < Tk && visible(qpos, kpos, causal, window);
      const float p = vis ? expf(s[c] * scale - lse_s[i]) : 0.f;
      p_s[row * (kB + 1) + i] = p;
      ds_s[row * (kB + 1) + i] = p * (dp[c] - dl_s[i]);
    }
    __syncwarp();  // a key row's P/dS are written and read by the same 4 lanes

    // dv += P^T . dO, dk += dS^T . Q (query rows past Tq have P = dS = 0)
    const float* pr = p_s + row * (kB + 1);
    const float* dsr = ds_s + row * (kB + 1);
#pragma unroll 2
    for (int i = 0; i < kB; ++i) {
      const float p = pr[i], x = dsr[i];
      const float* qi = q_s + i * (D + 1);
      const float* di = do_s + i * (D + 1);
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        acc_v[c] += p * di[sub + c * kTPR];
        acc_k[c] += x * qi[sub + c * kTPR];
      }
    }
  }

  if (kpos < Tk) {
    const int64_t o = k_base + static_cast<int64_t>(kpos) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[o + sub + c * kTPR] = acc_k[c] * scale;
      dv[o + sub + c * kTPR] = acc_v[c];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int BH, Tq, Tk;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq_simt(const Args& a, void* dq) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Tq + kB - 1) / kB, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.Tq, a.Tk, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_simt(const Args& a, void* dk, void* dv) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Tk + kB - 1) / kB, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.Tq, a.Tk, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dk/dv, bf16: the tensor-core route
// ---------------------------------------------------------------------------
constexpr int kKeys = 128;  // keys a block: two warpgroups of 64
constexpr int kQT = 64;     // queries a Q/dO tile (the N of S^T = K.Q^T)
constexpr int kStages = 3;  // Q/dO tiles in flight: one barrier a tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvTiles {
  static constexpr int kv_bytes = kKeys * D * 2;  // one swizzled K or V tile
  static constexpr int q_bytes = kQT * D * 2;      // one Q or dO tile
  static constexpr int stage_bytes = 2 * q_bytes;
  static constexpr int vec_bytes = kQT * 4;  // one lse or delta tile
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t smem =
      2 * kv_bytes + kStages * (stage_bytes + 2 * vec_bytes) + 1024;
};

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Tq, int Tk, float scale,
                           int causal, int window) {
  using L = DkvTiles<D>;
  constexpr int NT = 256;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const aligned = smem_raw + (((tc::smem_u32(smem_raw) + 1023) & ~1023u) -
                                       tc::smem_u32(smem_raw));
  const uint32_t k_s = tc::smem_u32(aligned), v_s = k_s + L::kv_bytes;
  const uint32_t qd_s = v_s + L::kv_bytes;  // stage st: Q at + st * stage_bytes, dO after it
  // stage st: lse at vec + 2 * st * kQT, delta at + kQT after it
  const float* vec =
      reinterpret_cast<const float*>(aligned + 2 * L::kv_bytes + kStages * L::stage_bytes);
  const uint32_t vec_s = tc::smem_u32(vec);

  // causal: the longest (first) key tiles of every head run first
  const int bh = blockIdx.x, k0 = blockIdx.y * kKeys;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int64_t q_base = static_cast<int64_t>(bh) * Tq * D;
  const int64_t k_base = static_cast<int64_t>(bh) * Tk * D;
  const float* lse_h = lse + static_cast<int64_t>(bh) * Tq;
  const float* dl_h = delta + static_cast<int64_t>(bh) * Tq;

  // queries that can see some key of this tile: causal needs q >= k0; the
  // window needs q < k + window, at most k0 + kKeys - 1 + window - 1
  const int q_begin = causal ? k0 / kQT * kQT : 0;
  int q_end = Tq;
  if (window > 0) q_end = min(q_end, k0 + kKeys - 1 + window);
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + kQT - 1) / kQT : 0;

  auto load_q_tile = [&](int st, int q0) {
    const uint32_t dst = qd_s + st * L::stage_bytes;
    tc::load_tile<kQT, D, NT>(dst, q + q_base, q0, Tq);
    tc::load_tile<kQT, D, NT>(dst + L::q_bytes, dout + q_base, q0, Tq);
    tc::load_vec<kQT, NT>(vec_s + 8 * st * kQT, lse_h, q0, Tq);
    tc::load_vec<kQT, NT>(vec_s + 8 * st * kQT + 4 * kQT, dl_h, q0, Tq);
  };
  tc::load_tile<kKeys, D, NT>(k_s, k + k_base, k0, Tk);
  tc::load_tile<kKeys, D, NT>(v_s, v + k_base, k0, Tk);
  if (n_tiles > 0) load_q_tile(0, q_begin);
  tc::cp_async_commit();

  // this warpgroup's 64 keys start at kw; this thread holds keys ka, ka + 8
  const int kw = k0 + wg * 64;
  const int ka = kw + warp * 16 + lane / 4;
  const float sl2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kQT, st = it % kStages;
    const uint32_t q_t = qd_s + st * L::stage_bytes, do_t = q_t + L::q_bytes;
    const float* lse_t = vec + 2 * st * kQT;
    const float* dl_t = lse_t + kQT;
    // the stage refilled here was last read in tile it - 2, and every
    // thread is past it: the barrier below, in tile it - 1, came after it
    if (it + 1 < n_tiles) load_q_tile((it + 1) % kStages, q0 + kQT);
    tc::cp_async_commit();  // possibly empty: one group a tile either way
    tc::cp_async_wait<1>();  // this tile (and K, V) have landed
    tc::fence_proxy_async();
    __syncthreads();

    // a warpgroup with no visible pair in this tile skips it
    if (kw >= Tk || (causal && q0 + kQT - 1 < kw) || (window > 0 && q0 >= kw + 63 + window))
      continue;

    // Four products in three groups, so the MUFU and FMA work of P and dS
    // runs under the tensor cores: P^T is formed while dP^T is still being
    // computed, and dS^T while dV += P^T.dO runs (groups complete in order).
    float s[kQT / 2], dp[kQT / 2];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss_n64(s, tc::desc_k<kKeys>(k_s, wg * 64, kk), tc::desc_k<kQT>(q_t, 0, kk), kk > 0);
    tc::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss_n64(dp, tc::desc_k<kKeys>(v_s, wg * 64, kk), tc::desc_k<kQT>(do_t, 0, kk),
                     kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // S^T is in
    tc::pin(s);

    const bool edge = (causal && q0 < kw + 63) || (window > 0 && q0 + kQT - 1 >= kw + window) ||
                      q0 + kQT > Tq || kw + 64 > Tk;
#pragma unroll
    for (int i = 0; i < kQT / 2; ++i) {
      const int key = ka + 8 * ((i / 2) % 2);
      const int c = (i / 4) * 8 + (lane % 4) * 2 + i % 2, qpos = q0 + c;
      const bool vis = !edge || (qpos < Tq && key < Tk && (!causal || key <= qpos) &&
                                 (window <= 0 || key > qpos - window));
      s[i] = vis ? tc::ex2(fmaf(s[i], sl2, -lse_t[c] * kLog2e)) : 0.f;
    }
    uint32_t pa[kQT / 16][4], dsa[kQT / 16][4];
    tc::to_a_operand(s, pa);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQT / 16; ++kk)
      tc::mma_rs<D>(dv_acc, pa[kk], tc::desc_mn<kQT>(do_t, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // dP^T is in; dV may still run
    tc::pin(dp);

#pragma unroll
    for (int i = 0; i < kQT / 2; ++i) {
      const int c = (i / 4) * 8 + (lane % 4) * 2 + i % 2;
      dp[i] = s[i] * (dp[i] - dl_t[c]);
    }
    tc::to_a_operand(dp, dsa);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQT / 16; ++kk)
      tc::mma_rs<D>(dk_acc, dsa[kk], tc::desc_mn<kQT>(q_t, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::pin(dv_acc);
    tc::pin(dk_acc);
    tc::pin(pa);
    tc::pin(dsa);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = ka + 8 * h;
    if (key >= Tk) continue;
    const int64_t o = k_base + static_cast<int64_t>(key) * D + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dk + o + j * 8) =
          __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + j * 8) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = DkvTiles<D>::smem;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.BH, (a.Tk + kKeys - 1) / kKeys), 256, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.Tq, a.Tk, a.scale,
      a.causal, a.window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dq, bf16: the tensor-core route
// ---------------------------------------------------------------------------
constexpr int kDqStages = 4;  // K/V tiles in flight (see the stage note in the kernel)
constexpr int kDqWarpgroups = 2;  // 64-row q-tiles a block, sharing each K/V stage
constexpr int kKT = 64;           // keys a K/V tile (the N of S = Q.K^T)

template <int D, int NWG>
struct DqTiles {
  static constexpr int BM = 64 * NWG;           // q rows a block
  static constexpr int q_bytes = BM * D * 2;    // one swizzled Q or dO tile
  static constexpr int kv_bytes = kKT * D * 2;  // one K or V tile
  static constexpr int stage_bytes = 2 * kv_bytes;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t smem = 2 * q_bytes + kDqStages * stage_bytes + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Tq,
                          int Tk, float scale, int causal, int window) {
  using L = DqTiles<D, NWG>;
  constexpr int BM = L::BM, NT = 128 * NWG, BK = kKT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (tc::smem_u32(smem_raw) + 1023) & ~1023u, do_s = q_s + L::q_bytes;
  const uint32_t kv_s = do_s + L::q_bytes;  // stage st: K at + st * stage_bytes, V after it

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
  tc::load_tile<BM, D, NT>(do_s, dout + q_base, q0, Tq);
  if (n_tiles > 0) {
    tc::load_tile<BK, D, NT>(kv_s, k + k_base, k_begin, Tk);
    tc::load_tile<BK, D, NT>(kv_s + L::kv_bytes, v + k_base, k_begin, Tk);
  }
  tc::cp_async_commit();

  // this warpgroup's 64 rows start at r0; this thread holds rows ra, ra + 8,
  // and their lse (in log2 units) and delta stay in registers
  const int r0 = q0 + wg * 64;
  const int ra = r0 + warp * 16 + lane / 4;
  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    const int64_t r = static_cast<int64_t>(bh) * Tq + row;
    lse2[h] = row < Tq ? lse[r] * kLog2e : 0.f;
    dl[h] = row < Tq ? delta[r] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t dsa[BK / 16][4] = {};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    const uint32_t k_s = kv_s + (it % kDqStages) * L::stage_bytes, v_s = k_s + L::kv_bytes;
    // The stage refilled here was last read in tile it - 3, by its dQ
    // product, which every thread waited for in tile it - 2, before the
    // barrier of tile it - 1 that this thread has passed. (Three stages would
    // not do: a dQ product is still reading its K tile while the other
    // warpgroup, one barrier ahead, refills the third stage back.)
    if (it + 1 < n_tiles) {
      const uint32_t nk = kv_s + ((it + 1) % kDqStages) * L::stage_bytes;
      tc::load_tile<BK, D, NT>(nk, k + k_base, k0 + BK, Tk);
      tc::load_tile<BK, D, NT>(nk + L::kv_bytes, v + k_base, k0 + BK, Tk);
    }
    tc::cp_async_commit();  // possibly empty: one group a tile either way
    tc::cp_async_wait<1>();  // this tile (and Q, dO) have landed
    tc::fence_proxy_async();
    __syncthreads();

    // a warpgroup with no visible pair in this tile skips it
    if (r0 >= Tq || (causal && k0 > r0 + 63) || (window > 0 && k0 + BK - 1 <= r0 - window)) {
      tc::wgmma_wait<0>();
      tc::pin(acc);
      tc::pin(dsa);
      continue;
    }

    // Three products in three groups (they complete in order): P is formed
    // while dP = dO.V^T is still on the tensor cores, and dQ += dS.K is left
    // running into the next tile, under its barrier and its first products.
    float s[BK / 2], dp[BK / 2];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss_n64(s, tc::desc_k<BM>(q_s, wg * 64, kk), tc::desc_k<BK>(k_s, 0, kk), kk > 0);
    tc::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss_n64(dp, tc::desc_k<BM>(do_s, wg * 64, kk), tc::desc_k<BK>(v_s, 0, kk), kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // the previous tile's dQ product and S are in
    tc::pin(dsa);
    tc::pin(s);

    const bool edge = (causal && k0 + BK - 1 > r0) || (window > 0 && k0 <= r0 + 63 - window) ||
                      k0 + BK > Tk || r0 + 64 > Tq;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) % 2, row = ra + 8 * h;
      const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + i % 2;
      const bool vis = !edge || (row < Tq && col < Tk && (!causal || col <= row) &&
                                 (window <= 0 || col > row - window));
      s[i] = vis ? tc::ex2(fmaf(s[i], sl2, -lse2[h])) : 0.f;
    }
    tc::wgmma_wait<0>();  // dP is in, and its registers are released
    tc::pin(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);

    // dQ += dS.K: dS rounded to bf16 is the register A operand as it stands,
    // the same K tile read down its rows (MN-major) the B operand
    tc::to_a_operand(dp, dsa);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) tc::mma_rs<D>(acc, dsa[kk], tc::desc_mn<BK>(k_s, kk), 1);
    tc::wgmma_commit();
  }
  tc::wgmma_wait<0>();
  tc::pin(acc);
  tc::pin(dsa);

  if (r0 >= Tq) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    if (row >= Tq) continue;
    __nv_bfloat16* orow = dq + q_base + static_cast<int64_t>(row) * D + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch_dq_wgmma(const Args& a, void* dq) {
  using L = DqTiles<D, kDqWarpgroups>;
  auto kernel = flash_bwd_dq_wgmma_kernel<D, kDqWarpgroups>;
  cudaError_t err = allow_smem(kernel, L::smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.BH, (a.Tq + L::BM - 1) / L::BM), 128 * kDqWarpgroups, L::smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(dq), a.Tq, a.Tk, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

extern "C" {

// q, dout [BH, Tq, D]; k, v [BH, Tk, D]; lse, delta f32 [BH, Tq]; dq [BH, Tq, D]
// in q's dtype (bf16: 16-byte aligned rows). All contiguous. window <= 0 means
// no window. bf16 runs the tensor-core kernel, f32 the scalar one.
int flash_attention_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int BH, int Tq,
                                int Tk, int D, int dtype, float scale, int causal, int window,
                                void* stream) {
  const rtt::Args a{q, k, v, dout, lse, delta, BH, Tq, Tk, scale, causal, window,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == rtt::kBFloat16 && D == 64) return rtt::launch_dq_wgmma<64>(a, dq);
  if (dtype == rtt::kBFloat16 && D == 128) return rtt::launch_dq_wgmma<128>(a, dq);
  if (dtype == rtt::kFloat32 && D == 64) return rtt::launch_dq_simt<64>(a, dq);
  if (dtype == rtt::kFloat32 && D == 128) return rtt::launch_dq_simt<128>(a, dq);
  return cudaErrorInvalidValue;
}

// the same inputs; dk, dv [BH, Tk, D] in k's dtype (bf16: 16-byte aligned
// rows). bf16 runs the tensor-core kernel, f32 the scalar one.
int flash_attention_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int BH,
                                 int Tq, int Tk, int D, int dtype, float scale, int causal,
                                 int window, void* stream) {
  const rtt::Args a{q, k, v, dout, lse, delta, BH, Tq, Tk, scale, causal, window,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == rtt::kBFloat16 && D == 64) return rtt::launch_dkv_wgmma<64>(a, dk, dv);
  if (dtype == rtt::kBFloat16 && D == 128) return rtt::launch_dkv_wgmma<128>(a, dk, dv);
  if (dtype == rtt::kFloat32 && D == 64) return rtt::launch_dkv_simt<64>(a, dk, dv);
  if (dtype == rtt::kFloat32 && D == 128) return rtt::launch_dkv_simt<128>(a, dk, dv);
  return cudaErrorInvalidValue;
}

}  // extern "C"
