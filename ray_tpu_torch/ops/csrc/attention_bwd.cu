// Blockwise FlashAttention backward (FlashAttention-2 split, no atomics):
//
//   flash_attention_backward_dq   dq = scale * sum_k P o (dP - delta) . K
//     replaces ray_tpu/ops/attention.py::_bwd_dq_kernel (K4);
//   flash_attention_backward_dkv  dv = sum_q P^T . dO,
//                                 dk = scale * sum_q (P o (dP - delta))^T . Q
//     replaces ray_tpu/ops/attention.py::_bwd_dkv_kernel (K5);
//
// both reached through the driver _flash_backward and the custom VJP of
// flash_attention_with_lse. P = exp(q.k * scale - lse) is recomputed from the
// forward's saved lse; delta = rowsum(dO o O) - g_lse comes from the caller
// (plain PyTorch, as the TPU driver computes it in plain XLA), so the lse
// cotangent folds into the same term. Causal, non-causal or sliding window
// (key k visible to query q iff k > q - window), as the forward kernel.
//
// What bounds it on the H100: at the training shape (B*H = 96, T = 2048,
// D = 128, causal) both kernels are bound by operations (6 and 8 FLOPs per
// visible (q, k) pair per head dimension): 0.156 and 0.209 ms a call at the
// tensor cores' 989 TFLOP/s. This first version runs scalar f32 FMAs over
// shared-memory tiles, as the forward does, so it is bound by the
// shared-memory loads feeding those FMAs: 12.1 and 15.6 ms a call on an H100
// SXM (80 GB HBM3, 700 W limit; PERF.md). wgmma and TMA come later (ROADMAP).
// Design:
//   * one block per (b*h, 32-row tile): dq walks the k-tiles its q-tile can
//     see, dk/dv the q-tiles that can see its k-tile, each accumulating in
//     f32 registers and writing its own rows once -- no atomics, so the
//     result is bitwise the same run to run (bit-exact resume needs that);
//   * 128 threads, 4 per tile row; each thread computes 8 scores of its row
//     with the head dimension as the outer loop, so one load of its own row
//     element feeds 8 FMAs;
//   * tiles that hold no visible pair are never loaded (above the causal
//     diagonal, left of the window, and for dk/dv past q + window);
//   * P is SELECTED by the mask, never multiplied by it: a row that sees no
//     key has lse = -1e30, and exp(s - lse) = inf would turn 0 * inf into NaN;
//   * rows past Tq / Tk are never loaded (zero-filled tiles) and never
//     written, instead of padding the inputs as the TPU driver does; for
//     dk/dv such query rows get P = 0.
// Shared memory: f32 tiles of q, dO, k, v and the P / dS tiles: ~37 KB (dq)
// and ~42 KB (dk/dv) at D=64, ~70 KB and ~75 KB at D=128, above the 48 KB
// default (the opt-in in common.cuh; a refused launch returns its error).
#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Tq, int Tk,
                    float scale, int causal, int window) {
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

  load_tile<T, D>(q_s, q, q_base, q0, Tq);
  load_tile<T, D>(do_s, dout, q_base, q0, Tq);

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
    load_tile<T, D>(k_s, k, k_base, k0, Tk);
    load_tile<T, D>(v_s, v, k_base, k0, Tk);
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
    for (int i = 0; i < DPT; ++i) dq[o + sub + i * kTPR] = from_f32<T>(acc[i] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Tq, int Tk, float scale, int causal, int window) {
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

  load_tile<T, D>(k_s, k, k_base, k0, Tk);
  load_tile<T, D>(v_s, v, k_base, k0, Tk);

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
    load_tile<T, D>(q_s, q, q_base, q0, Tq);
    load_tile<T, D>(do_s, dout, q_base, q0, Tq);
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
      dk[o + sub + c * kTPR] = from_f32<T>(acc_k[c] * scale);
      dv[o + sub + c * kTPR] = from_f32<T>(acc_v[c]);
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

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Tq + kB - 1) / kB, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(dq), a.Tq, a.Tk, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Tk + kB - 1) / kB, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(dk), static_cast<T*>(dv), a.Tq, a.Tk,
      a.scale, a.causal, a.window);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

extern "C" {

// q, dout [BH, Tq, D]; k, v [BH, Tk, D]; lse, delta f32 [BH, Tq]; dq [BH, Tq, D]
// in q's dtype. All contiguous. window <= 0 means no window.
int flash_attention_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int BH, int Tq,
                                int Tk, int D, int dtype, float scale, int causal, int window,
                                void* stream) {
  const rtt::Args a{q, k, v, dout, lse, delta, BH, Tq, Tk, scale, causal, window,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == rtt::kFloat32 && D == 64) return rtt::launch_dq<float, 64>(a, dq);
  if (dtype == rtt::kFloat32 && D == 128) return rtt::launch_dq<float, 128>(a, dq);
  if (dtype == rtt::kBFloat16 && D == 64) return rtt::launch_dq<__nv_bfloat16, 64>(a, dq);
  if (dtype == rtt::kBFloat16 && D == 128) return rtt::launch_dq<__nv_bfloat16, 128>(a, dq);
  return cudaErrorInvalidValue;
}

// the same inputs; dk, dv [BH, Tk, D] in k's dtype
int flash_attention_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int BH,
                                 int Tq, int Tk, int D, int dtype, float scale, int causal,
                                 int window, void* stream) {
  const rtt::Args a{q, k, v, dout, lse, delta, BH, Tq, Tk, scale, causal, window,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == rtt::kFloat32 && D == 64) return rtt::launch_dkv<float, 64>(a, dk, dv);
  if (dtype == rtt::kFloat32 && D == 128) return rtt::launch_dkv<float, 128>(a, dk, dv);
  if (dtype == rtt::kBFloat16 && D == 64) return rtt::launch_dkv<__nv_bfloat16, 64>(a, dk, dv);
  if (dtype == rtt::kBFloat16 && D == 128)
    return rtt::launch_dkv<__nv_bfloat16, 128>(a, dk, dv);
  return cudaErrorInvalidValue;
}

}  // extern "C"
