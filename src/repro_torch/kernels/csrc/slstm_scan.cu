// sLSTM time scan for Hopper (sm_90a): the recurrence of the sLSTM block over a
// whole sequence, from the hoisted gate pre-activations and the per-head
// recurrent weights, with the final state as a second output.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/slstm_scan.py  slstm_scan_pallas  (_kernel)
//
// What it computes. gx (B, S, 4, D) in gate order z, i, f, o (fp32 or bf16,
// widened to fp32) and r (4, H, hd, hd) fp32, D = H * hd. For each batch row and
// head, from c = n = h = 0 and m = -1e30, each step t does
//   pre_g = gx[t, g] + h @ r[g]                       (g = z, i, f, o)
//   z = tanh(pre_z), o = sigmoid(pre_o), logf = log_sigmoid(pre_f)
//   m' = max(logf + m, pre_i), i = exp(pre_i - m'), f = exp(logf + m - m')
//   c' = f c + i z, n' = f n + i, h' = o c' / max(n', 1e-6)
// and writes h' to h_out (B, S, D) fp32; after the last step it writes
// (c, n, h, m) to state (4, B, H, hd) fp32. The reference kernel returns h only
// (its state lives in VMEM scratch across its sequential grid axis); serving's
// prefill needs the final state too, which the reference takes from lax.scan.
// The reference requires S % chunk == 0 for its grid; a loop inside the block
// walks the whole sequence here, so the chunk is the wrapper's check only.
//
// What bounds it on this card. Not bytes and not operations: S dependent
// steps, each a (hd) x (hd, 4 hd) matrix-vector product per (row, head), then
// the gate math, with two block-wide barriers. At serving's shape (batch 4,
// 1024 steps, 4 heads of 192) the bytes (gx read once, h written once, r once)
// and the 2 * 4 hd^2 operations a step are ~0.07 ms of work at the card's
// peaks, while the grid has only B * H blocks (16 on 132 SMs) and each step
// waits for the last. Its time per step (ms * 1000 / S) is the number to watch.
//
// Design (a first, simple one).
//   * One block per (head, batch row): grid (H, B), 4 * hd threads (768 at
//     hd 192, 256 at hd 64; at most 1024, so hd <= 256). __launch_bounds__
//     (1024) caps registers at 64 a thread.
//   * Thread j owns gate j / hd and output column j % hd. Each step it forms
//     sum_k h[k] r[gate, head, k, col] with h in shared memory (a broadcast
//     read) and r from device memory: neighbouring threads read neighbouring
//     columns, so each k is one coalesced row, and the 2.36 MB of r at full
//     width stays resident in L2 across steps. One head's four gates are
//     589,824 bytes in fp32, more than a block's 227 KB of shared memory, so
//     r cannot live there at full width; a cluster of 4 blocks, one gate each
//     in shared memory, exchanging h through distributed shared memory, is the
//     redesign (ROADMAP).
//   * The pre-activations go to shared memory; after a barrier the first hd
//     threads apply the gate math with c, n and m in registers, write h to
//     shared memory and to h_out, and a second barrier ends the step.
//   * gx for a step is loaded before the product, so its latency overlaps it.
//
// Numerics. Not bitwise: the reference's product sums in another order (its
// cell as an einsum per gate, its kernel as one dot on the MXU), so the kernel
// is held to a tolerance (kernels/cases.py SLSTM_TOL). The product is an
// explicit fmaf chain over k; log_sigmoid is min(x, 0) - log1p(exp(-|x|)),
// finite for any finite x; expf, tanhf, log1pf and the division are the
// accurate ones (no fast math, -fmad=false). Subnormals are kept: the
// reference's CPU runs flush them (port rule 5), but the model path is held by
// tolerance, not bits, and a flush would change nothing it checks.
//
// Plain C interface (loaded with ctypes): raw device pointers and a
// cudaStream_t; launches on that stream, does not synchronise, and returns the
// launch's CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHd = 256;
constexpr int kMaxThreads = 4 * kMaxHd;   // 1024, a block's limit
constexpr float kM0 = -1e30f;             // the running max at t = 0

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
slstm_scan_kernel(const T* __restrict__ gx, const float* __restrict__ r,
                  float* __restrict__ h_out, float* __restrict__ state, int S, int H,
                  int hd, long long B) {
  __shared__ float h_s[kMaxHd];
  __shared__ float pre_s[kMaxThreads];
  const long long head = blockIdx.x;
  const long long b = blockIdx.y;
  const int j = threadIdx.x;                // 0 .. 4 hd - 1
  const int gate = j / hd;
  const int col = j - gate * hd;
  const long long D = static_cast<long long>(H) * hd;
  // r[gate, head, k, col] = rcol[k * hd]
  const float* rcol = r + (gate * static_cast<long long>(H) + head) * hd * hd + col;
  // gx[b, t, gate, head * hd + col] = gcol[t * 4 D]
  const T* gcol = gx + b * S * 4 * D + gate * D + head * hd + col;
  // h_out[b, t, head * hd + j] = hrow[t * D], for j < hd
  float* hrow = h_out + b * S * D + head * hd + j;

  float c = 0.f, n = 0.f, h = 0.f, m = kM0;
  if (j < hd) h_s[j] = 0.f;
  __syncthreads();
  for (int t = 0; t < S; ++t) {
    const float g = widen(gcol[static_cast<long long>(t) * 4 * D]);
    float dot = 0.f;
#pragma unroll 8
    for (int k = 0; k < hd; ++k)
      dot = fmaf(h_s[k], __ldg(rcol + static_cast<long long>(k) * hd), dot);
    pre_s[j] = g + dot;
    __syncthreads();
    if (j < hd) {
      const float z = tanhf(pre_s[j]);
      const float i_in = pre_s[hd + j];
      const float log_f = log_sigmoid(pre_s[2 * hd + j]);
      const float o = sigmoid(pre_s[3 * hd + j]);
      const float m_new = fmaxf(log_f + m, i_in);
      const float i_s = expf(i_in - m_new);
      const float f_s = expf(log_f + m - m_new);
      c = f_s * c + i_s * z;
      n = f_s * n + i_s;
      h = o * c / fmaxf(n, 1e-6f);
      m = m_new;
      h_s[j] = h;
      hrow[static_cast<long long>(t) * D] = h;
    }
    __syncthreads();
  }
  if (j < hd) {
    const long long at = (b * H + head) * hd + j;
    const long long plane = B * D;
    state[at] = c;
    state[plane + at] = n;
    state[2 * plane + at] = h;
    state[3 * plane + at] = m;
  }
}

template <typename T>
int launch(const void* gx, const void* r, void* h_out, void* state, long long B, long long S,
           long long H, long long hd, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  slstm_scan_kernel<T><<<grid, static_cast<unsigned>(4 * hd), 0, stream>>>(
      static_cast<const T*>(gx), static_cast<const float*>(r), static_cast<float*>(h_out),
      static_cast<float*>(state), static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(hd), B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// gx: (B,S,4,H*hd) fp32 (bf16 = 0) or bf16 (bf16 = 1); r: (4,H,hd,hd) fp32;
// h_out: (B,S,H*hd) fp32; state: (4,B,H,hd) fp32 = c, n, h, m after step S.
// 1 <= hd <= 256, B < 65536, S and H < 2^31.
int slstm_scan_fwd(const void* gx, const void* r, void* h_out, void* state, long long B,
                   long long S, long long H, long long hd, int bf16, void* stream) {
  if (B == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (B < 0 || B >= 65536 || S < 0 || S >= (1LL << 31) || H < 0 || H >= (1LL << 31) ||
      hd < 1 || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(gx, r, h_out, state, B, S, H, hd, s);
  return launch<float>(gx, r, h_out, state, B, S, H, hd, s);
}

}  // extern "C"
