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
// the gate math. At serving's shape (batch 4, 1024 steps, 4 heads of 192) the
// bytes (gx read once, h written once, r once) and the 2 * 4 hd^2 operations a
// step are ~0.07 ms of work at the card's peaks; the time is the latency of a
// step, and its time per step (ms * 1000 / S) is the number to watch. The
// first design (one block per (row, head), r streamed from L2 each step, two
// block barriers) took ~9.3 us a step: a 192-deep dependent chain of L2 reads.
//
// Design: a cluster of CTAs per (batch row, head), r in shared memory.
//   * Cluster of 4 CTAs, one per gate (cooperative_groups::this_cluster(),
//     launched with cudaLaunchKernelEx and a cluster dimension). CTA g loads
//     gate g's (hd, hd) slice of r into dynamic shared memory once (147,456 B
//     at hd 192) and never reads r from device memory inside the step loop.
//     Where one gate's slice and the buffers do not fit a block's 232,448 B
//     (hd above 224) each gate's columns split over 2 CTAs: a cluster of 8,
//     still a portable size. The wrapper picks the layout from hd
//     (kernels/slstm_scan.py::cluster_layout) and passes it here; this file
//     recomputes it (layout_for) and refuses a mismatch.
//   * A short chain: each thread owns two columns (local c and c + P, P the
//     padded count of column pairs) and one of 4 k-slices of hd_k / 4 rows
//     (hd_k: hd rounded up to 16, zero rows beyond hd); a warp is 8 column
//     pairs x 4 slices (lane = 8 slice + pair), so a slice's 8 lanes read 8
//     consecutive float4 of r (no bank conflict) and one float4 of h (a
//     broadcast). r is laid out [slice][k / 4][column][k % 4]. Four partial
//     sums per column, then two shuffles (xor 8, 16) sum the slices; the
//     butterfly leaves the same bits in all four lanes.
//   * One exchange and one cluster barrier a step: lane of slice s adds gx
//     and stores its two pre-activations into the exchange buffer of cluster
//     ranks s, s + 4 (all of them), through distributed shared memory; then
//     cluster.sync(). Every CTA applies the gate math to all hd units
//     redundantly (the same bits everywhere), so each has the new h locally
//     for the next step and no second exchange is needed. The exchange slots
//     alternate by step parity: a CTA writes slot t & 1 of step t + 2 only
//     after the barrier of step t + 1, which every CTA reaches after reading
//     slot t & 1. The only other barrier is the CTA's __syncthreads between
//     the gate math (writing h) and the next step's product (reading it).
//   * h_out stores are spread over the ranks (rank j writes units
//     [j u, (j + 1) u), u = ceil(hd / cluster)); rank 0 writes the final
//     state. gx is prefetched kPrefetch steps ahead into registers.
//   * Shared memory per CTA: 4 (hd_k * 2P + 2 * 4 * hd + hd_k) bytes:
//     154,368 at hd 192 (cluster 4), 140,288 at hd 256 (cluster 8).
//   * The launch checks cudaOccupancyMaxActiveClusters > 0 and returns its
//     error otherwise; clusters need sm_90.
//   Per-step floor of this design, in cycles of one SM (PERF.md): reading one
//   gate's r from shared memory, 147,456 B at 128 B a cycle (~1,150), plus
//   the h broadcasts, two shuffles, the remote stores, one cluster barrier and
//   the gate math's dependent chain (tanh, exp, log1p, two divisions).
//
// Numerics. Not bitwise: the reference's product sums in another order (its
// cell as an einsum per gate, its kernel as one dot on the MXU), so the kernel
// is held to a tolerance (kernels/cases.py SLSTM_TOL). The product is explicit
// fmaf in four partial sums per slice; log_sigmoid is min(x, 0) -
// log1p(exp(-|x|)), finite for any finite x; expf, tanhf, log1pf and the
// division are the accurate ones (no fast math, -fmad=false). Subnormals are
// kept: the reference's CPU runs flush them (port rule 5), but the model path
// is held by tolerance, not bits, and a flush would change nothing it checks.
//
// Plain C interface (loaded with ctypes): raw device pointers and a
// cudaStream_t; launches on that stream, does not synchronise, and returns the
// first CUDA error of the attribute call, the occupancy query or the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHd = 256;
constexpr int kSlices = 4;                // k-slices per column pair
constexpr int kSmemLimit = 232448;        // a block's shared memory on an H100
constexpr int kMaxThreads = 512;          // the most a layout takes: 448, at hd 224
constexpr int kPrefetch = 4;              // steps of gx in flight
constexpr float kM0 = -1e30f;             // the running max at t = 0

struct ClusterLayout {
  int cluster;     // CTAs per (batch row, head): 4 * split, split CTAs a gate
  int ncols;       // columns of its gate a CTA owns: ceil(hd / split)
  int pairs;       // column pairs, padded to whole warps (8 per warp)
  int hd_k;        // rows of r held: hd rounded up to 16 (4 slices of float4)
  int threads;     // pairs * kSlices
  long long smem;  // r, the exchange buffers (2 x 4 x hd) and h (hd_k), in bytes
};

__host__ __device__ inline ClusterLayout layout_for(int hd, int split) {
  ClusterLayout L;
  L.cluster = 4 * split;
  L.ncols = (hd + split - 1) / split;
  L.pairs = ((L.ncols + 1) / 2 + 7) / 8 * 8;
  L.hd_k = (hd + 15) / 16 * 16;
  L.threads = L.pairs * kSlices;
  L.smem = 4LL * (static_cast<long long>(L.hd_k) * 2 * L.pairs + 2 * 4 * hd + L.hd_k);
  return L;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
slstm_cluster_kernel(const T* __restrict__ gx, const float* __restrict__ r,
                     float* __restrict__ h_out, float* __restrict__ state, int S, int H,
                     int hd, long long B, int split) {
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterLayout L = layout_for(hd, split);
  const int rank = static_cast<int>(cluster.block_rank());
  const int gate = rank / split;
  const int col0 = (rank % split) * L.ncols;   // first column of this CTA's gate slice
  const long long head = blockIdx.x / L.cluster;
  const long long b = blockIdx.y;
  const long long D = static_cast<long long>(H) * hd;
  const int cols = 2 * L.pairs;                // r's padded row length in shared memory
  const int kq = L.hd_k / kSlices / 4;         // float4 steps of k per slice

  extern __shared__ float4 smem4[];
  float* r_s = reinterpret_cast<float*>(smem4);   // [slice][k / 4][column][k % 4]
  float* x_s = r_s + static_cast<long long>(L.hd_k) * cols;   // [parity][gate][hd]
  float* h_s = x_s + 8 * hd;                                  // [hd_k], zero past hd

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int slice = lane >> 3;
  const int pair = (tid >> 5) * 8 + (lane & 7);

  // r[gate, head, k, col0 + c] for this CTA's columns, once
  const float* rg = r + (static_cast<long long>(gate) * H + head) * hd * hd;
  for (int e = tid; e < L.hd_k * cols; e += blockDim.x) {
    const int kk = e / cols;
    const int c = e - kk * cols;
    float val = 0.f;
    if (kk < hd && c < L.ncols && col0 + c < hd)
      val = rg[static_cast<long long>(kk) * hd + col0 + c];
    const int sl = kk / (kq * 4);
    const int kr = kk - sl * kq * 4;
    r_s[((sl * kq + kr / 4) * cols + c) * 4 + (kr & 3)] = val;
  }
  for (int e = tid; e < L.hd_k; e += blockDim.x) h_s[e] = 0.f;

  // this thread's two columns: local pair and pair + pairs
  const int ca = col0 + pair, cb = col0 + pair + L.pairs;
  const bool va = pair < L.ncols && ca < hd;
  const bool vb = pair + L.pairs < L.ncols && cb < hd;
  // gx[b, t, gate, head * hd + col] = g?[t * 4 D]
  const T* gbase = gx + b * S * 4 * D + gate * D + head * hd;
  const T* ga = gbase + (va ? ca : 0);
  const T* gb = gbase + (vb ? cb : 0);
  float pa[kPrefetch], pb[kPrefetch];
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    pa[i] = va && i < S ? widen(ga[static_cast<long long>(i) * 4 * D]) : 0.f;
    pb[i] = vb && i < S ? widen(gb[static_cast<long long>(i) * 4 * D]) : 0.f;
  }

  // the gate math: thread u < hd owns unit u (in every CTA of the cluster)
  const int unit = tid;
  const int per_rank = (hd + L.cluster - 1) / L.cluster;
  const bool writes_h = unit < hd && unit / per_rank == rank;
  float* hrow = h_out + b * S * D + head * hd + unit;
  float c = 0.f, n = 0.f, h = 0.f, m = kM0;

  const float4* rp = reinterpret_cast<const float4*>(r_s) + slice * kq * cols + pair;
  const float4* hp = reinterpret_cast<const float4*>(h_s) + slice * kq;

  cluster.sync();   // every CTA of the cluster runs and holds its r before any remote store
  for (int t0 = 0; t0 < S; t0 += kPrefetch) {
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int t = t0 + i;
      if (t < S) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll 4
        for (int j = 0; j < kq; ++j) {
          const float4 hv = hp[j];
          const float4 ra = rp[j * cols];
          const float4 rb = rp[j * cols + L.pairs];
          a0 = fmaf(hv.x, ra.x, a0);
          a1 = fmaf(hv.y, ra.y, a1);
          a2 = fmaf(hv.z, ra.z, a2);
          a3 = fmaf(hv.w, ra.w, a3);
          b0 = fmaf(hv.x, rb.x, b0);
          b1 = fmaf(hv.y, rb.y, b1);
          b2 = fmaf(hv.z, rb.z, b2);
          b3 = fmaf(hv.w, rb.w, b3);
        }
        float da = (a0 + a1) + (a2 + a3);
        float db = (b0 + b1) + (b2 + b3);
        da += __shfl_xor_sync(0xffffffffu, da, 8);
        db += __shfl_xor_sync(0xffffffffu, db, 8);
        da += __shfl_xor_sync(0xffffffffu, da, 16);
        db += __shfl_xor_sync(0xffffffffu, db, 16);
        const float pre_a = pa[i] + da;
        const float pre_b = pb[i] + db;
        if (t + kPrefetch < S) {
          const long long at = static_cast<long long>(t + kPrefetch) * 4 * D;
          pa[i] = va ? widen(ga[at]) : 0.f;
          pb[i] = vb ? widen(gb[at]) : 0.f;
        }
        const int slot = ((t & 1) * 4 + gate) * hd;
        for (int dst = slice; dst < L.cluster; dst += kSlices) {
          float* xr = cluster.map_shared_rank(x_s, dst) + slot;
          if (va) xr[ca] = pre_a;
          if (vb) xr[cb] = pre_b;
        }
        cluster.sync();

        if (unit < hd) {
          const float* xp = x_s + (t & 1) * 4 * hd + unit;
          const float z = tanhf(xp[0]);
          const float i_in = xp[hd];
          const float log_f = log_sigmoid(xp[2 * hd]);
          const float o = sigmoid(xp[3 * hd]);
          const float m_new = fmaxf(log_f + m, i_in);
          const float i_s = expf(i_in - m_new);
          const float f_s = expf(log_f + m - m_new);
          c = f_s * c + i_s * z;
          n = f_s * n + i_s;
          h = o * c / fmaxf(n, 1e-6f);
          m = m_new;
          h_s[unit] = h;
          if (writes_h) hrow[static_cast<long long>(t) * D] = h;
        }
        __syncthreads();
      }
    }
  }
  if (rank == 0 && unit < hd) {
    const long long at = (b * H + head) * hd + unit;
    const long long plane = B * D;
    state[at] = c;
    state[plane + at] = n;
    state[2 * plane + at] = h;
    state[3 * plane + at] = m;
  }
}

template <typename T>
int launch(const void* gx, const void* r, void* h_out, void* state, long long B, long long S,
           long long H, long long hd, int split, int threads, long long smem,
           cudaStream_t stream) {
  const ClusterLayout L = layout_for(static_cast<int>(hd), split);
  if (L.threads != threads || L.smem != smem || L.smem > kSmemLimit || L.threads > kMaxThreads ||
      L.threads < hd || L.cluster * H >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = slstm_cluster_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(L.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(L.cluster * H), static_cast<unsigned>(B));
  cfg.blockDim = dim3(static_cast<unsigned>(L.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(L.smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(gx),
                           static_cast<const float*>(r), static_cast<float*>(h_out),
                           static_cast<float*>(state), static_cast<int>(S),
                           static_cast<int>(H), static_cast<int>(hd), B, split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// gx: (B,S,4,H*hd) fp32 (bf16 = 0) or bf16 (bf16 = 1); r: (4,H,hd,hd) fp32;
// h_out: (B,S,H*hd) fp32; state: (4,B,H,hd) fp32 = c, n, h, m after step S.
// 1 <= hd <= 256, B < 65536, S and H < 2^31. split (CTAs per gate), threads
// and smem are the wrapper's layout for hd; a layout other than layout_for's
// is refused.
int slstm_scan_fwd(const void* gx, const void* r, void* h_out, void* state, long long B,
                   long long S, long long H, long long hd, int bf16, int split, int threads,
                   long long smem, void* stream) {
  if (B == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (B < 0 || B >= 65536 || S < 0 || S >= (1LL << 31) || H < 0 || H >= (1LL << 31) ||
      hd < 1 || hd > kMaxHd || (split != 1 && split != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(gx, r, h_out, state, B, S, H, hd, split, threads, smem, s);
  return launch<float>(gx, r, h_out, state, B, S, H, hd, split, threads, smem, s);
}

}  // extern "C"
