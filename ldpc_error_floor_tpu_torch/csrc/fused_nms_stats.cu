// Fused neural min-sum decode, stats mode, fixed T iterations.
//
// Replaces ldpc_error_floor_tpu/ops/pallas_decoder.py::FusedNMSKernel._kernel
// (mode='stats', fixed-T loop) for the MS, QMS and MS_RAW decoding types.
// Its plain PyTorch version is ops/fused_decoder.py::decode_stats_plain, a
// port of the scan body of ldpc_error_floor_tpu/models/nms.py; under QMS the
// two agree bit for bit.
//
// What bounds it on an H100: on-chip work, not device memory.  A codeword
// moves ~4.7 KB through device memory (LLRs in, APP out, T flags and counts)
// but every iteration touches each of its E*z edge slots about twice in
// shared memory and spends ~16 simple f32 operations on each (adds,
// compares, selects; no FMA), so the operation count and shared-memory
// traffic are ~20x the device-memory time at 3.35 TB/s.
//
// What the design does about it: the whole decoder state of G codewords
// (the C->V messages [E*z] plus one sum [N*z] per bit, and the UCN parity
// bits) stays in shared memory for all T iterations; device memory sees the
// LLRs (read through the cache each iteration), the final APP and the
// per-iteration flags and counts only.  Shared arrays are laid out
// [row][G] with the codeword fastest, so the 32 lanes of a warp read 32
// consecutive words of one bank row.  Each iteration is two phases split
// by __syncthreads():
//   A. one thread per lifted bit and word: the slot-ordered sum S of its
//      C->V messages; the previous iteration's APP, hard decision and error
//      count; this iteration's weighted, quantized channel value plus S.
//   B. one thread per lifted check and word: for each real edge (no
//      padding to the largest check degree) the V->C message
//      (bit total - own C->V), min1/min2 and the sign product; then the
//      extrinsic magnitude, eps fix, CN/UCN weight, ReLU, quantize or clip,
//      sign, written back in place over the same C->V slot.
// Rounding follows the scan decoder: rintf (half to even, as jnp.round and
// torch.round), IEEE division, and the build uses -fmad=false so no
// multiply-add is contracted.  It launches on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPadMag = 1.0e4f;  // magnitude sentinel of the extrinsic min
constexpr float kEps = 1.0e-4f;    // zero-message nudge

constexpr int kMS = 1;
constexpr int kQMS = 2;

__device__ __forceinline__ float quantize(float x, float step, float qclip) {
  return fminf(fmaxf(rintf(x / step) * step, -qclip), qclip);
}

__device__ __forceinline__ float clip(float x, float lim) {
  return fminf(fmaxf(x, -lim), lim);
}

// Per-iteration weight of one check / edge under a sharing mode:
// 1, 4 per edge (CN order), 2, 5 per check, 3 scalar.
__device__ __forceinline__ float cn_weight(const float* __restrict__ w,
                                           int t, int dim, int mode, int i,
                                           int k) {
  int col = (mode == 1 || mode == 4) ? k : ((mode == 2 || mode == 5) ? i : 0);
  return __ldg(w + (size_t)t * dim + col);
}

// V->C message of one edge slot: bit total minus the edge's own C->V,
// quantized (QMS) or clipped, zero nudged to eps (MS, QMS).
__device__ __forceinline__ float v2c_msg(float tot, float c2v, int dec_type,
                                         float qstep, float qclip,
                                         float clip_llr) {
  float x = tot - c2v;
  x = (dec_type == kQMS) ? quantize(x, qstep, qclip) : clip(x, clip_llr);
  if ((dec_type == kMS || dec_type == kQMS) && x == 0.0f) x = kEps;
  return x;
}

// tab layout (int32): vn_ptr[N+1] | cn_ptr[M+1] | cn_edge[E] | edge_vn[E] |
// edge_shift[E].  Edges are numbered in VN order, so VN j owns the edge
// range [vn_ptr[j], vn_ptr[j+1]); cn_edge lists each check's edges in CN
// order, so position k there is the CN-order index of the edge.
__global__ void __launch_bounds__(1024)
fused_nms_stats_kernel(const float* __restrict__ llr,
                       const float* __restrict__ w_cn,
                       const float* __restrict__ w_ucn,
                       const float* __restrict__ w_vn,
                       const int* __restrict__ tab,
                       float* __restrict__ app_out,
                       uint8_t* __restrict__ err_out,
                       int* __restrict__ nerr_out,
                       int N, int M, int z, int E, int T, int B, int G,
                       int target, int dec_type, float qstep, float qclip,
                       float clip_llr, int cn_mode, int ucn, int vn_mode,
                       int offset_mode, int dim_cn, int dim_vn) {
  extern __shared__ float smem[];  // ops/fused_decoder.py::_smem_bytes
  const int NzG = N * z * G;
  const int MzG = M * z * G;
  const int EzG = E * z * G;
  float* c2v = smem;                                  // [E*z][G]
  float* tot = c2v + EzG;                             // [N*z][G]
  int* cnt = reinterpret_cast<int*>(tot + NzG);       // [2][G]
  uint8_t* bits = reinterpret_cast<uint8_t*>(cnt + 2 * G);  // [N*z][G]

  const int* vn_ptr = tab;
  const int* cn_ptr = vn_ptr + N + 1;
  const int* cn_edge = cn_ptr + M + 1;
  const int* edge_vn = cn_edge + E;
  const int* edge_shift = edge_vn + E;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * G;
  const bool qms = dec_type == kQMS;
  const int gt = tid % G;  // blockDim.x % G == 0: a thread keeps its word

  for (int k = tid; k < EzG; k += nthr) c2v[k] = 0.0f;
  if (tid < 2 * G) cnt[tid] = 0;
  __syncthreads();

  for (int t = 0; t <= T; ++t) {
    const int p = t & 1;
    // ---- phase A: per lifted bit --------------------------------------
    int wrong = 0;
    for (int k = tid; k < NzG; k += nthr) {
      const int row = k / G;
      const int j = row / z;
      const int s = row - j * z;
      const int b = b0 + gt;
      float S = 0.0f;
      const int e1 = vn_ptr[j + 1];
      for (int e = vn_ptr[j]; e < e1; ++e) {
        const float c = c2v[(e * z + s) * G + gt];
        S = (e == vn_ptr[j]) ? c : S + c;
      }
      const float x = (b < B) ? __ldg(llr + (size_t)row * B + b) : 0.0f;
      if (t > 0) {  // APP and stats of iteration t-1
        const float base = qms ? quantize(x, qstep, qclip) : x;
        const float app = clip(base + S, clip_llr);
        const bool bit = app >= 0.0f;
        if (j < target) wrong += bit;
        if (ucn) bits[k] = bit;
        if (t == T && b < B) app_out[(size_t)row * B + b] = app;
      }
      if (t < T) {
        float lw = x;
        if (vn_mode > 0)
          lw = x * __ldg(w_vn + (size_t)t * dim_vn +
                         ((vn_mode == 2 || vn_mode == 5) ? j : 0));
        if (qms) lw = quantize(lw, qstep, qclip);
        tot[k] = lw + S;
        if (ucn && t == 0) bits[k] = lw >= 0.0f;
      }
    }
    if (t > 0 && wrong) atomicAdd(&cnt[p * G + gt], wrong);
    __syncthreads();
    if (tid < G) {
      const int b = b0 + tid;
      if (t > 0 && b < B) {
        const int n = cnt[p * G + tid];
        err_out[(size_t)(t - 1) * B + b] = n > 0;
        nerr_out[(size_t)(t - 1) * B + b] = n;
      }
      cnt[(p ^ 1) * G + tid] = 0;
    }
    if (t == T) break;

    // ---- phase B: per lifted check ------------------------------------
    for (int k = tid; k < MzG; k += nthr) {
      const int g = gt;
      const int row = k / G;
      const int i = row / z;
      const int h = row - i * z;
      const int k0 = cn_ptr[i], k1 = cn_ptr[i + 1];
      float u = 0.0f;
      if (ucn) {
        int par = 0;
        for (int q = k0; q < k1; ++q) {
          const int e = cn_edge[q];
          const int sl = (h + edge_shift[e]) % z;
          par ^= bits[(edge_vn[e] * z + sl) * G + g];
        }
        u = (float)par;
      }
      float m1 = kPadMag, m2 = kPadMag, sgn_tot = 1.0f;
      for (int q = k0; q < k1; ++q) {
        const int e = cn_edge[q];
        const int sl = (h + edge_shift[e]) % z;
        const float x = v2c_msg(tot[(edge_vn[e] * z + sl) * G + g],
                                c2v[(e * z + sl) * G + g], dec_type, qstep,
                                qclip, clip_llr);
        const float a = (x == 0.0f) ? kPadMag : fabsf(x);
        m2 = fminf(m2, fmaxf(m1, a));
        m1 = fminf(m1, a);
        sgn_tot *= (x > 0.0f) ? -1.0f : 1.0f;
      }
      for (int q = k0; q < k1; ++q) {
        const int e = cn_edge[q];
        const int sl = (h + edge_shift[e]) % z;
        const int ci = (e * z + sl) * G + g;
        const float x = v2c_msg(tot[(edge_vn[e] * z + sl) * G + g], c2v[ci],
                                dec_type, qstep, qclip, clip_llr);
        const float a = (x == 0.0f) ? kPadMag : fabsf(x);
        const float sg = (x > 0.0f) ? -1.0f : 1.0f;
        float mag = (a == m1) ? m2 : m1;
        mag = (mag <= kEps) ? mag - kEps : mag;
        const float out = mag * (-(sgn_tot * sg));
        float wmag = mag;
        if (cn_mode > 0) {
          float w = cn_weight(w_cn, t, dim_cn, cn_mode, i, q);
          if (ucn) {
            const float wu = cn_weight(w_ucn, t, dim_cn, cn_mode, i, q);
            w = w * (1.0f - u) + wu * u;
          }
          wmag = offset_mode ? mag - w : mag * w;
        }
        wmag = (wmag > 0.0f) ? wmag : 0.0f;
        wmag = qms ? quantize(wmag, qstep, qclip) : clip(wmag, clip_llr);
        const float so = (out > 0.0f) ? 1.0f : ((out < 0.0f) ? -1.0f : 0.0f);
        c2v[ci] = wmag * so;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// `smem` is the dynamic shared memory of one block, the layout carved at the
// top of the kernel (ops/fused_decoder.py::_smem_bytes computes it).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_nms_stats_launch(
    const void* llr, const void* w_cn, const void* w_ucn, const void* w_vn,
    const void* tab, void* app, void* err, void* nerr, int N, int M, int z,
    int E, int T, int B, int G, int threads, int smem, int target,
    int dec_type, float qstep, float qclip, float clip_llr, int cn_mode,
    int ucn, int vn_mode, int offset_mode, int dim_cn, int dim_vn,
    void* stream) {
  cudaError_t st = cudaFuncSetAttribute(
      fused_nms_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (st != cudaSuccess) return (int)st;
  const int blocks = (B + G - 1) / G;
  fused_nms_stats_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)llr, (const float*)w_cn, (const float*)w_ucn,
      (const float*)w_vn, (const int*)tab, (float*)app, (uint8_t*)err,
      (int*)nerr, N, M, z, E, T, B, G, target, dec_type, qstep, qclip,
      clip_llr, cn_mode, ucn, vn_mode, offset_mode, dim_cn, dim_vn);
  return (int)cudaGetLastError();
}
