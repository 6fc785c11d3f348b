// The fused neural min-sum / sum-product decode loop, shared by the decode
// library (csrc/fused_nms_stats.cu: fixed T, genie early stop, syndrome
// stop) and the training library (csrc/fused_nms_train.cu: the streaming
// forward B4 is the mode kTrain of this loop; the backward B5 uses the
// helpers).  The iteration exists once, so B4 decodes exactly as B1.
//
// What the design does: the whole decoder state of G codewords (the C->V
// messages [E*z] plus one sum [N*z] per bit, and the parity bits) stays in
// shared memory for all T iterations; device memory sees the LLRs (read
// through the cache each iteration), the outputs of the mode and, in
// kTrain, the residual streams.  Shared arrays are laid out [row][G] with
// the codeword fastest, so the 32 lanes of a warp read 32 consecutive words
// of one bank row.  Each iteration is two phases split by __syncthreads():
//   A. one thread per lifted bit and word: the slot-ordered sum S of its
//      C->V messages; the previous iteration's APP, hard decision and error
//      count; this iteration's weighted, quantized channel value plus S.
//   B. one thread per lifted check and word: the parity of the previous
//      hard decisions (UCN mask, and the syndrome in deploy mode); for each
//      real edge (no padding to the largest check degree) the V->C message
//      (bit total - own C->V); min1/min2 and the sign product, or SP's tanh
//      prefix/suffix product; then the CN/UCN weight, ReLU, quantize or
//      clip, sign, written back in place over the same C->V slot.
// The stops end a block's loop, never a thread's: early stop decides with
// __syncthreads_or after the statistics of an iteration, deploy after phase
// B, from shared flags that every thread reads alike.  A block of G words
// stops as a whole (the JAX tile stops as a whole too, at another size), so
// the early-stop rows after a block's stop and its APP depend on G; the
// genie-failure mask and every deploy output do not.
// kTrain counts nothing and writes, straight to device memory with the word
// fastest (the G threads of a row write G consecutive words), the pre-clip
// APPs of iterations t >= t0 and, when hist_out is not null, per iteration
// the pre-clip V->C message of every edge slot and the check residuals: for
// the min-sum types min1, min2, the negated sign product and the UCN mask;
// for SP (whose backward recomputes the tanh products) the UCN mask alone.
// Nothing is staged asynchronously, so no copy can read a buffer that is
// being rewritten.
// Rounding follows the scan decoder: rintf (half to even, as jnp.round and
// torch.round), IEEE division, and the build uses -fmad=false so no
// multiply-add is contracted.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPadMag = 1.0e4f;  // magnitude sentinel of the extrinsic min
constexpr float kEps = 1.0e-4f;    // zero-message nudge
constexpr float kSPClip = (float)(1.0 - 1e-7);  // SP product clip
constexpr int kMaxDegSP = 64;      // largest check degree SP takes

constexpr int kSPDec = 0;  // decoding types
constexpr int kMS = 1;
constexpr int kQMS = 2;

constexpr int kFixed = 0;
constexpr int kEarlyStop = 1;
constexpr int kDeploy = 2;
constexpr int kTrain = 3;

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

// V->C message of one edge slot from its pre-clip value (bit total minus
// the edge's own C->V): quantized (QMS) or clipped, zero nudged to eps (MS,
// QMS).
__device__ __forceinline__ float v2c_msg(float pre, int dec_type, float qstep,
                                         float qclip, float clip_llr) {
  float x = (dec_type == kQMS) ? quantize(pre, qstep, qclip)
                               : clip(pre, clip_llr);
  if ((dec_type == kMS || dec_type == kQMS) && x == 0.0f) x = kEps;
  return x;
}

// Graph table (int32): vn_ptr[N+1] | cn_ptr[M+1] | cn_edge[E] | edge_vn[E] |
// edge_shift[E] | edge_cn[E] (the last in the training table only).  Edges
// are numbered in VN order, so VN j owns the edge range [vn_ptr[j],
// vn_ptr[j+1]); cn_edge lists each check's edges in CN order, so position k
// there is the CN-order index of the edge.
struct Graph {
  const int* vn_ptr;
  const int* cn_ptr;
  const int* cn_edge;
  const int* edge_vn;
  const int* edge_shift;
  const int* edge_cn;
  int z, G;

  __device__ Graph(const int* tab, int N, int M, int E, int z_, int G_)
      : vn_ptr(tab), cn_ptr(tab + N + 1), cn_edge(tab + N + M + 2),
        edge_vn(tab + N + M + 2 + E), edge_shift(tab + N + M + 2 + 2 * E),
        edge_cn(tab + N + M + 2 + 3 * E), z(z_), G(G_) {}

  // Slot-ordered sum of a per-slot array over lifted bit (j, s) of word g.
  __device__ __forceinline__ float bit_sum(const float* a, int j, int s,
                                           int g) const {
    float S = 0.0f;
    const int e0 = vn_ptr[j], e1 = vn_ptr[j + 1];
    for (int e = e0; e < e1; ++e) {
      const float c = a[(e * z + s) * G + g];
      S = (e == e0) ? c : S + c;
    }
    return S;
  }

  // Parity of the hard decisions on the bits of lifted check (i, h), word g.
  __device__ __forceinline__ int check_parity(const uint8_t* bits, int i,
                                              int h, int g) const {
    int par = 0;
    for (int q = cn_ptr[i]; q < cn_ptr[i + 1]; ++q) {
      const int e = cn_edge[q];
      par ^= bits[(edge_vn[e] * z + (h + edge_shift[e]) % z) * G + g];
    }
    return par;
  }
};

// Shared memory of one block (ops/fused_decoder.py::_smem_bytes computes its
// size): C->V float [E*z][G] | bit totals float [N*z][G] | error counts int
// [2][G] | deploy only: frozen int [G], last unsatisfied step int [G] |
// parity bits uint8 [N*z][G] (with UCN or in deploy mode).
// Outputs: stats modes app [N*z][B] (clipped), err uint8 [T][B], nerr int
// [T][B]; deploy app, err uint8 [B], nerr int [B], iters int [B], fail uint8
// [B]; kTrain app [T-t0][target*z][B] (pre-clip) and, with hist_out, hist
// [T][E*z][B] and cres [T][R*M*z][B] (min-sum: R = 4 with UCN, else 3; SP:
// R = 1 with UCN, else no cres).
template <int kMode, bool kSP>
__global__ void __launch_bounds__(1024)
fused_nms_kernel(const float* __restrict__ llr,
                 const float* __restrict__ w_cn,
                 const float* __restrict__ w_ucn,
                 const float* __restrict__ w_vn,
                 const int* __restrict__ tab,
                 float* __restrict__ app_out,
                 uint8_t* __restrict__ err_out,
                 int* __restrict__ nerr_out,
                 int* __restrict__ iters_out,
                 uint8_t* __restrict__ fail_out,
                 float* __restrict__ hist_out,
                 float* __restrict__ cres_out,
                 int N, int M, int z, int E, int T, int B, int G,
                 int target, int t0, int dec_type, float qstep, float qclip,
                 float clip_llr, int cn_mode, int ucn, int vn_mode,
                 int offset_mode, int dim_cn, int dim_vn) {
  constexpr bool kDep = kMode == kDeploy;
  constexpr bool kTr = kMode == kTrain;
  extern __shared__ float smem[];
  const int NzG = N * z * G;
  const int MzG = M * z * G;
  const int EzG = E * z * G;
  float* c2v = smem;
  float* tot = c2v + EzG;
  int* cnt = reinterpret_cast<int*>(tot + NzG);
  // deploy: frozen[g] = word g's syndrome held at an iteration <= t-3 (as of
  // phase A of step t); unsat_at[g] = the last step whose phase B found an
  // unsatisfied check of word g (step s tests iteration s-1's decisions)
  int* frozen = cnt + 2 * G;
  int* unsat_at = frozen + G;
  uint8_t* bits = reinterpret_cast<uint8_t*>(cnt + (kDep ? 4 : 2) * G);
  const bool need_bits = ucn || kDep;
  const Graph gr(tab, N, M, E, z, G);
  const size_t Ez = (size_t)E * z, Mz = (size_t)M * z;
  const bool stream = kTr && hist_out != nullptr;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * G;
  const bool qms = dec_type == kQMS;
  const int gt = tid % G;  // blockDim.x % G == 0: a thread keeps its word
  const int b = b0 + gt;
  bool still_wrong = true;  // early stop, threads tid < G: word tid

  for (int k = tid; k < EzG; k += nthr) c2v[k] = 0.0f;
  if (tid < 2 * G) cnt[tid] = 0;
  if (kDep && tid < G) {
    frozen[tid] = 0;
    unsat_at[tid] = -1;
  }
  __syncthreads();

  int t = 0;
  for (; t <= T; ++t) {
    const int p = t & 1;
    // deploy: outputs of iteration t-1 are written while no iteration
    // <= t-2 satisfied the syndrome (t-2's was tested in phase B of step t-1)
    const bool live =
        !kDep || (!frozen[gt] && !(t >= 2 && unsat_at[gt] != t - 1));
    // ---- phase A: per lifted bit --------------------------------------
    int wrong = 0;
    for (int k = tid; k < NzG; k += nthr) {
      const int row = k / G;
      const int j = row / z;
      const float S = gr.bit_sum(c2v, j, row - j * z, gt);
      const float x = (b < B) ? __ldg(llr + (size_t)row * B + b) : 0.0f;
      if (t > 0) {  // APP and stats of iteration t-1
        const float base = qms ? quantize(x, qstep, qclip) : x;
        if (kTr) {  // the pre-clip APP of the window; its sign is the clipped one's
          const float app = base + S;
          if (ucn) bits[k] = app >= 0.0f;
          if (b < B && t - 1 >= t0 && j < target)
            app_out[((size_t)(t - 1 - t0) * target * z + row) * B + b] = app;
        } else {
          const float app = clip(base + S, clip_llr);
          const bool bit = app >= 0.0f;
          if (j < target) wrong += bit;
          if (need_bits) bits[k] = bit;
          if (b < B && (kDep ? live : t == T))
            app_out[(size_t)row * B + b] = app;
        }
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
    int go = 0;  // early stop: a word of the block wrong at every iteration
    if (!kTr && tid < G) {
      if (t > 0 && b < B) {
        const int n = cnt[p * G + tid];
        if (kDep) {
          if (live) {
            err_out[b] = n > 0;
            nerr_out[b] = n;
            iters_out[b] = t;
          }
        } else {
          err_out[(size_t)(t - 1) * B + b] = n > 0;
          nerr_out[(size_t)(t - 1) * B + b] = n;
        }
        still_wrong = still_wrong && n > 0;
        go = still_wrong;
      }
      cnt[(p ^ 1) * G + tid] = 0;
      if (kDep) frozen[tid] = !live;
    }
    if (kMode == kEarlyStop && t > 0 && !__syncthreads_or(go)) {
      if (t < T) {
        // every word has decoded at least once: leave iteration t-1's APP
        // (the C->V state is still that of t-1) and zero the skipped rows
        for (int k = tid; k < NzG; k += nthr) {
          const int row = k / G;
          const int j = row / z;
          if (b < B) {
            const float x = __ldg(llr + (size_t)row * B + b);
            const float base = qms ? quantize(x, qstep, qclip) : x;
            app_out[(size_t)row * B + b] =
                clip(base + gr.bit_sum(c2v, j, row - j * z, gt), clip_llr);
          }
        }
        if (tid < G && b < B)
          for (int r = t; r < T; ++r) {
            err_out[(size_t)r * B + b] = 0;
            nerr_out[(size_t)r * B + b] = 0;
          }
      }
      break;
    }
    if (t == T) break;

    // ---- phase B: per lifted check ------------------------------------
    for (int k = tid; k < MzG; k += nthr) {
      const int g = gt;
      const int row = k / G;
      const int i = row / z;
      const int h = row - i * z;
      const int k0 = gr.cn_ptr[i], k1 = gr.cn_ptr[i + 1];
      float u = 0.0f;
      if (ucn || (kDep && t > 0)) {
        const int par = gr.check_parity(bits, i, h, g);
        u = (float)par;
        if (kDep && t > 0 && par) unsat_at[g] = t;  // all writers store t
      }
      if (kSP) {
        // tanh of each V->C message, stashed in its own C->V slot (this
        // thread owns the check's slots), then suffix products in suf[];
        // streaming, the pre-clip value goes out before its slot is
        // overwritten, and the UCN mask is the check's one residual
        float suf[kMaxDegSP];
        if (stream && ucn && b < B)
          cres_out[((size_t)t * Mz + row) * B + b] = u;
        for (int q = k0; q < k1; ++q) {
          const int e = gr.cn_edge[q];
          const int sl = (h + gr.edge_shift[e]) % z;
          const int ci = (e * z + sl) * G + g;
          const float pre = tot[(gr.edge_vn[e] * z + sl) * G + g] - c2v[ci];
          if (stream && b < B)
            hist_out[((size_t)t * Ez + (size_t)e * z + sl) * B + b] = pre;
          const float x = v2c_msg(pre, dec_type, qstep, qclip, clip_llr);
          const float v = tanhf(-0.5f * x);
          c2v[ci] = (v == 0.0f) ? 1.0f : v;
        }
        float acc = 1.0f;
        for (int q = k1 - 1; q >= k0; --q) {
          const int e = gr.cn_edge[q];
          const float v = c2v[(e * z + (h + gr.edge_shift[e]) % z) * G + g];
          suf[q - k0] = acc;
          acc = (q == k1 - 1) ? v : acc * v;
        }
        float pre = 1.0f;
        for (int q = k0; q < k1; ++q) {
          const int e = gr.cn_edge[q];
          const int ci = (e * z + (h + gr.edge_shift[e]) % z) * G + g;
          const float v = c2v[ci];
          float prod = (q == k0) ? suf[0]
                       : ((q == k1 - 1) ? pre : pre * suf[q - k0]);
          pre = (q == k0) ? v : pre * v;
          prod = fminf(fmaxf(prod, -kSPClip), kSPClip);
          const float out = -2.0f * atanhf(prod);
          float wmag = fabsf(out);
          if (cn_mode > 0) {
            float w = cn_weight(w_cn, t, dim_cn, cn_mode, i, q);
            if (ucn) {
              const float wu = cn_weight(w_ucn, t, dim_cn, cn_mode, i, q);
              w = w * (1.0f - u) + wu * u;
            }
            wmag = offset_mode ? wmag - w : wmag * w;
          }
          wmag = (wmag > 0.0f) ? wmag : 0.0f;
          wmag = qms ? quantize(wmag, qstep, qclip) : clip(wmag, clip_llr);
          const float so = (out > 0.0f) ? 1.0f : ((out < 0.0f) ? -1.0f : 0.0f);
          c2v[ci] = wmag * so;
        }
        continue;
      }
      float m1 = kPadMag, m2 = kPadMag, sgn_tot = 1.0f;
      for (int q = k0; q < k1; ++q) {
        const int e = gr.cn_edge[q];
        const int sl = (h + gr.edge_shift[e]) % z;
        const float pre = tot[(gr.edge_vn[e] * z + sl) * G + g] -
                          c2v[(e * z + sl) * G + g];
        if (stream && b < B)
          hist_out[((size_t)t * Ez + (size_t)e * z + sl) * B + b] = pre;
        const float x = v2c_msg(pre, dec_type, qstep, qclip, clip_llr);
        const float a = (x == 0.0f) ? kPadMag : fabsf(x);
        m2 = fminf(m2, fmaxf(m1, a));
        m1 = fminf(m1, a);
        sgn_tot *= (x > 0.0f) ? -1.0f : 1.0f;
      }
      if (stream && b < B) {
        const size_t r0 = (size_t)t * (ucn ? 4 : 3) * Mz + row;
        cres_out[r0 * B + b] = m1;
        cres_out[(r0 + Mz) * B + b] = m2;
        cres_out[(r0 + 2 * Mz) * B + b] = -sgn_tot;
        if (ucn) cres_out[(r0 + 3 * Mz) * B + b] = u;
      }
      for (int q = k0; q < k1; ++q) {
        const int e = gr.cn_edge[q];
        const int sl = (h + gr.edge_shift[e]) % z;
        const int ci = (e * z + sl) * G + g;
        const float x = v2c_msg(tot[(gr.edge_vn[e] * z + sl) * G + g] - c2v[ci],
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
    if (kDep && t > 0) {
      // every word's syndrome held at some iteration <= t-1: its outputs
      // are all written.  Every thread reads the same flags: uniform.
      bool done = true;
      for (int g = 0; g < G && b0 + g < B; ++g)
        done = done && (frozen[g] || unsat_at[g] != t);
      if (done) break;
    }
  }

  if (kDep) {
    if (t == T) {  // the syndrome of the last iteration, T-1
      for (int k = tid; k < MzG; k += nthr) {
        const int row = k / G;
        const int i = row / z;
        if (gr.check_parity(bits, i, row - i * z, gt)) unsat_at[gt] = T;
      }
      __syncthreads();
    }
    if (tid < G && b < B) fail_out[b] = !frozen[tid] && unsat_at[tid] == T;
  }
}

// One launch of fused_nms_kernel<kMode, kSP> on `stream` with `smem` bytes
// of dynamic shared memory per block of G words.  Returns
// cudaGetLastError() after the launch (0 = launched).
template <int kMode, bool kSP>
int launch(const void* llr, const void* w_cn, const void* w_ucn,
           const void* w_vn, const void* tab, void* app, void* err,
           void* nerr, void* iters, void* fail, void* hist, void* cres,
           int N, int M, int z, int E, int T, int B, int G, int threads,
           int smem, int target, int t0, int dec_type, float qstep,
           float qclip, float clip_llr, int cn_mode, int ucn, int vn_mode,
           int offset_mode, int dim_cn, int dim_vn, cudaStream_t stream) {
  cudaError_t st = cudaFuncSetAttribute(
      fused_nms_kernel<kMode, kSP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return (int)st;
  const int blocks = (B + G - 1) / G;
  fused_nms_kernel<kMode, kSP><<<blocks, threads, smem, stream>>>(
      (const float*)llr, (const float*)w_cn, (const float*)w_ucn,
      (const float*)w_vn, (const int*)tab, (float*)app, (uint8_t*)err,
      (int*)nerr, (int*)iters, (uint8_t*)fail, (float*)hist, (float*)cres,
      N, M, z, E, T, B, G, target, t0, dec_type, qstep, qclip, clip_llr,
      cn_mode, ucn, vn_mode, offset_mode, dim_cn, dim_vn);
  return (int)cudaGetLastError();
}

}  // namespace
