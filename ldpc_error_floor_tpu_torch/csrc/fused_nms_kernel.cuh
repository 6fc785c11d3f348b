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
// the codeword fastest (G a power of two, so a row index is a shift), and
// the 32 lanes of a warp read 32 consecutive words of one bank row.  Each
// iteration is two phases split by __syncthreads():
//   A. one thread per lifted bit and word: the slot-ordered sum S of its
//      C->V messages; the previous iteration's APP, hard decision and error
//      count; this iteration's weighted, quantized channel value plus S.
//   B. one thread per lifted check and word: the parity of the previous
//      hard decisions (UCN mask, and the syndrome in deploy mode); for each
//      real edge (no padding to the largest check degree) the V->C message
//      (bit total - own C->V), derived once and kept in the edge's own C->V
//      slot (this thread owns the check's slots) until the second pass
//      reads it back; min1/min2 and the sign product, or SP's tanh
//      prefix/suffix product; then the CN/UCN weight, ReLU, quantize or
//      clip, sign, written back in place over the same C->V slot.
// What bounds it on an H100 is issue latency, not bytes: each slot costs a
// few shared loads and ~16 simple f32 operations per iteration, so the
// design keeps everything a slot needs on chip and off the critical path:
//   - the graph table is staged into shared memory at block start, one
//     int4 {e*z, vn*z, shift, e} per check-order edge, so one broadcast load
//     gives an edge's slot bases and circulant shift; a slot index is
//     h + shift less z at most once (shifts are reduced mod z), and no
//     thread divides in the t loop (`Rows` steps its items' row / z and
//     row % z by a conditional subtract);
//   - the weights of iteration t are staged into shared memory once per
//     block and iteration (CN/UCN in phase A for phase B, VN in phase B for
//     the next phase A); phase B reads a per-check or scalar weight once per
//     check, a per-edge one once per slot;
//   - the QMS quantizer multiplies by 1/step (the wrappers take only
//     power-of-two steps, so x * (1/step) is the float x / step) and does no
//     division;
//   - kTrain (B4) runs two blocks per SM, under a launch bound of 576
//     threads and 56 registers, with the most words whose two blocks fit
//     (G = 8 on wman, where one block of 16 was 7.7% slower); the decode
//     modes keep one block of up to 1024 threads (their early-stop and SP
//     instances need more than 56 registers).
// The stops end a block's loop, never a thread's: early stop decides with
// __syncthreads_or after the statistics of an iteration, deploy after phase
// B, from shared flags that every thread reads alike.  A block of G words
// stops as a whole (the JAX tile stops as a whole too, at another size), so
// the early-stop rows after a block's stop and its APP depend on G; the
// genie-failure mask and every deploy output do not.
// kTrain counts nothing and writes, straight to device memory, the pre-clip
// APPs of iterations t >= t0 ([T-t0][target*z][B], the G threads of a row
// writing G consecutive words) and, when hist_out is not null, per
// iteration the pre-clip V->C message of every edge slot and the check
// residuals (for the min-sum types min1, min2, the negated sign product and
// the UCN mask; for SP, whose backward recomputes the tanh products, the
// UCN mask alone) in B5's tile-major layout: tiles of W words (B5's G),
// hist [tiles][T][E*z][W] and cres [tiles][T][R*M*z][W], so that one B5
// block's residuals of one iteration are one contiguous run.  Nothing is
// staged asynchronously here, so no copy can read a buffer that is being
// rewritten.
// Rounding follows the scan decoder: rintf (half to even, as jnp.round and
// torch.round), and the build uses -fmad=false so no multiply-add is
// contracted.

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

// Threads per block of the training pair (kTrain and B5), built to run two
// blocks per SM: at most 65,536 / (2 * 576) = 56 registers a thread
// (ops/fused_decoder.py::_TWO_BLOCK_THREADS).
constexpr int kTwoBlockThreads = 576;

__device__ __forceinline__ float clip(float x, float lim) {
  return fminf(fmaxf(x, -lim), lim);
}

// The message arithmetic of one decoding type: the QMS grid (step, its
// exact reciprocal, clip) or the LLR clip.
struct Msg {
  int dec_type;
  float qinv, qstep, qclip, clip_llr;

  __device__ bool qms() const { return dec_type == kQMS; }
  // Round to the QMS grid, then clip: x * qinv is exactly the float
  // x / qstep (qstep is a power of two), so no division.
  __device__ __forceinline__ float quantize(float x) const {
    return fminf(fmaxf(rintf(x * qinv) * qstep, -qclip), qclip);
  }
  // V->C message of one edge slot from its pre-clip value (bit total minus
  // the edge's own C->V): quantized (QMS) or clipped, zero nudged to eps
  // (MS, QMS).
  __device__ __forceinline__ float v2c(float pre) const {
    float x = qms() ? quantize(pre) : clip(pre, clip_llr);
    if ((dec_type == kMS || dec_type == kQMS) && x == 0.0f) x = kEps;
    return x;
  }
  // The clip (QMS: quantize) of a weighted C->V magnitude.
  __device__ __forceinline__ float out(float wmag) const {
    return qms() ? quantize(wmag) : clip(wmag, clip_llr);
  }
  // The clip of a V->C message and of a weighted magnitude.
  __device__ float msg_clip() const { return qms() ? qclip : clip_llr; }
};

// The graph table as the wrappers lay it out (int32): per check-order
// position q an int4 {e*z, vn*z, shift, e} of its edge e (E of them, so the
// table starts 16-byte aligned) | vn_ptr[N+1] | cn_ptr[M+1].  Edges are
// numbered in VN order, so VN j owns the edge range [vn_ptr[j],
// vn_ptr[j+1]); check i owns the positions [cn_ptr[i], cn_ptr[i+1]) in CN
// order.  Shifts are reduced mod z.  The kernels copy it into shared memory
// at block start (`stage_table`); `lg` is log2 G.
struct Graph {
  const int4* slot;
  const int* vn_ptr;
  const int* cn_ptr;
  int z, lg;

  // Shared index of the lifted bit / check / edge row `r` of word g.
  __device__ __forceinline__ int at(int r, int g) const { return (r << lg) + g; }

  // The lifted index sl = (h + shift) mod z of a check-order slot `sd` for
  // lifted check h, with one conditional subtract (h, shift < z).
  __device__ __forceinline__ int sub(int4 sd, int h) const {
    const int sl = h + sd.z;
    return sl >= z ? sl - z : sl;
  }

  // Slot-ordered sum of a per-slot array over lifted bit (j, s) of word g.
  __device__ __forceinline__ float bit_sum(const float* a, int j, int s,
                                           int g) const {
    float S = 0.0f;
    const int e0 = vn_ptr[j], e1 = vn_ptr[j + 1];
    int r = e0 * z + s;
    for (int e = e0; e < e1; ++e, r += z) {
      const float c = a[at(r, g)];
      S = (e == e0) ? c : S + c;
    }
    return S;
  }

  // Parity of the hard decisions on the bits of lifted check (i, h), word g.
  __device__ __forceinline__ int check_parity(const uint8_t* bits, int i,
                                              int h, int g) const {
    int par = 0;
    for (int q = cn_ptr[i]; q < cn_ptr[i + 1]; ++q) {
      const int4 sd = slot[q];
      par ^= bits[at(sd.y + sub(sd, h), g)];
    }
    return par;
  }
};

// Bytes of the staged graph table, rounded up to 16 (the arrays after it
// stay 16-byte aligned).
__host__ __device__ __forceinline__ int table_bytes(int N, int M, int E) {
  return ((4 * E + N + M + 2) * 4 + 15) & ~15;
}

// Copy the graph table into shared memory `dst` (the caller synchronises
// before use).
__device__ Graph stage_table(const int* __restrict__ tab, int* dst, int N,
                             int M, int E, int z, int G) {
  const int n = 4 * E + N + M + 2;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldg(tab + k);
  Graph gr;
  gr.slot = reinterpret_cast<const int4*>(dst);
  gr.vn_ptr = dst + 4 * E;
  gr.cn_ptr = dst + 4 * E + N + 1;
  gr.z = z;
  gr.lg = __ffs(G) - 1;
  return gr;
}

// The rows row0, row0 + step, ... of a [rows][G] array, each with its
// quotient and remainder by z, stepped without a division.
struct Rows {
  int row, q, r, step, dq, dr, z;

  __device__ Rows(int row0, int step_, int z_)
      : row(row0), q(row0 / z_), r(row0 % z_), step(step_),
        dq(step_ / z_), dr(step_ % z_), z(z_) {}
  __device__ __forceinline__ void next() {
    row += step;
    q += dq;
    r += dr;
    if (r >= z) {
      r -= z;
      ++q;
    }
  }
};

// Bytes of the decode kernel's shared memory (the layout below;
// ops/fused_decoder.py::_smem_bytes computes the same).
__host__ __device__ __forceinline__ int decode_smem_bytes(int N, int M, int z,
                                                          int E, int G,
                                                          int ucn, bool deploy) {
  return table_bytes(N, M, E) + 4 * ((2 * E + N + 3) & ~3) +
         4 * (E * z + N * z) * G + 4 * (deploy ? 4 : 2) * G +
         ((ucn || deploy) ? N * z * G : 0);
}

// Copy the weights of iteration t into shared memory: cn, ucn [dim_cn] and
// vn [dim_vn] (null or a dimension of 0: none).
__device__ __forceinline__ void stage_weights(const float* __restrict__ w,
                                              float* dst, int t, int dim) {
  if (w == nullptr) return;
  for (int d = threadIdx.x; d < dim; d += blockDim.x)
    dst[d] = __ldg(w + (size_t)t * dim + d);
}

// The weight column of check i, check-order position q under a sharing
// mode: 1, 4 per edge (CN order), 2, 5 per check, 3 scalar.
__device__ __forceinline__ int cn_col(int mode, int i, int q) {
  return (mode == 1 || mode == 4) ? q : ((mode == 2 || mode == 5) ? i : 0);
}

// The effective CN weight: the CN weight, blended with the UCN weight by
// the check's UCN mask u (0 or 1) when UCN is on.
__device__ __forceinline__ float cn_w(const float* wc, const float* wu,
                                      int col, int ucn, float u) {
  float w = wc[col];
  if (ucn) w = w * (1.0f - u) + wu[col] * u;
  return w;
}

// Shared memory of one block (ops/fused_decoder.py::_smem_bytes computes its
// size): graph table (`table_bytes`) | weights float [2E + N] (rounded to
// 16 bytes; cn, ucn and vn of one iteration) | C->V float [E*z][G] | bit
// totals float [N*z][G] | error counts int [2][G] | deploy only: frozen int
// [G], last unsatisfied step int [G] | parity bits uint8 [N*z][G] (with UCN
// or in deploy mode).
// Outputs: stats modes app [N*z][B] (clipped), err uint8 [T][B], nerr int
// [T][B]; deploy app, err uint8 [B], nerr int [B], iters int [B], fail uint8
// [B]; kTrain app [T-t0][target*z][B] (pre-clip) and, with hist_out, hist
// [tiles][T][E*z][W] and cres [tiles][T][R*M*z][W] (min-sum: R = 4 with
// UCN, else 3; SP: R = 1 with UCN, else no cres), tiles = ceil(B / W).
template <int kMode, bool kSP>
__global__ void __launch_bounds__(kMode == kTrain ? kTwoBlockThreads : 1024,
                                  kMode == kTrain ? 2 : 1)
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
                 int N, int M, int z, int E, int T, int B, int G, int W,
                 int target, int t0, Msg ms, int cn_mode, int ucn,
                 int vn_mode, int offset_mode, int dim_cn, int dim_vn) {
  constexpr bool kDep = kMode == kDeploy;
  constexpr bool kTr = kMode == kTrain;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Nz = N * z, Mz = M * z, Ez = E * z;
  const Graph gr = stage_table(tab, reinterpret_cast<int*>(smem_raw), N, M,
                               E, z, G);
  float* wc = reinterpret_cast<float*>(smem_raw + table_bytes(N, M, E));
  float* wu = wc + dim_cn;
  float* wv = wu + dim_cn;
  float* c2v = wc + ((2 * E + N + 3) & ~3);
  float* tot = c2v + Ez * G;
  int* cnt = reinterpret_cast<int*>(tot + Nz * G);
  // deploy: frozen[g] = word g's syndrome held at an iteration <= t-3 (as of
  // phase A of step t); unsat_at[g] = the last step whose phase B found an
  // unsatisfied check of word g (step s tests iteration s-1's decisions)
  int* frozen = cnt + 2 * G;
  int* unsat_at = frozen + G;
  uint8_t* bits = reinterpret_cast<uint8_t*>(cnt + (kDep ? 4 : 2) * G);
  const bool need_bits = ucn || kDep;
  const bool stream = kTr && hist_out != nullptr;
  const int R = kSP ? 1 : (ucn ? 4 : 3);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lg = gr.lg;
  const int b0 = blockIdx.x * G;
  const bool qms = ms.qms();
  const int gt = tid & (G - 1);  // blockDim.x % G == 0: a thread keeps its word
  const int b = b0 + gt;
  bool still_wrong = true;  // early stop, threads tid < G: word tid
  // this word's residual streams: tile b / W, lane b % W of it
  const int lgW = __ffs(W) - 1;
  const size_t lane_w = (size_t)(b & (W - 1));
  float* hist_w = stream ? hist_out + ((size_t)(b >> lgW) * T * Ez << lgW) + lane_w
                         : nullptr;
  float* cres_w = stream && cres_out != nullptr
                      ? cres_out + ((size_t)(b >> lgW) * T * R * Mz << lgW) + lane_w
                      : nullptr;
  const Rows rows0(tid >> lg, nthr >> lg, z);  // this thread's items
  const bool per_edge = cn_mode == 1 || cn_mode == 4;
  const int vn_per_bit = vn_mode == 2 || vn_mode == 5;

  for (int k = tid; k < Ez * G; k += nthr) c2v[k] = 0.0f;
  if (tid < 2 * G) cnt[tid] = 0;
  if (kDep && tid < G) {
    frozen[tid] = 0;
    unsat_at[tid] = -1;
  }
  if (vn_mode > 0) stage_weights(w_vn, wv, 0, dim_vn);
  __syncthreads();

  int t = 0;
  for (; t <= T; ++t) {
    const int p = t & 1;
    // deploy: outputs of iteration t-1 are written while no iteration
    // <= t-2 satisfied the syndrome (t-2's was tested in phase B of step t-1)
    const bool live =
        !kDep || (!frozen[gt] && !(t >= 2 && unsat_at[gt] != t - 1));
    // ---- phase A: per lifted bit --------------------------------------
    if (t < T && cn_mode > 0) {  // phase B's weights
      stage_weights(w_cn, wc, t, dim_cn);
      if (ucn) stage_weights(w_ucn, wu, t, dim_cn);
    }
    int wrong = 0;
    for (Rows it = rows0; it.row < Nz; it.next()) {
      const int row = it.row, j = it.q;
      const int k = gr.at(row, gt);
      const float S = gr.bit_sum(c2v, j, it.r, gt);
      const float x = (b < B) ? __ldg(llr + (size_t)row * B + b) : 0.0f;
      if (t > 0) {  // APP and stats of iteration t-1
        const float base = qms ? ms.quantize(x) : x;
        if (kTr) {  // the pre-clip APP of the window; its sign is the clipped one's
          const float app = base + S;
          if (ucn) bits[k] = app >= 0.0f;
          if (b < B && t - 1 >= t0 && j < target)
            app_out[((size_t)(t - 1 - t0) * target * z + row) * B + b] = app;
        } else {
          const float app = clip(base + S, ms.clip_llr);
          const bool bit = app >= 0.0f;
          if (j < target) wrong += bit;
          if (need_bits) bits[k] = bit;
          if (b < B && (kDep ? live : t == T))
            app_out[(size_t)row * B + b] = app;
        }
      }
      if (t < T) {
        float lw = x;
        if (vn_mode > 0) lw = x * wv[vn_per_bit ? j : 0];
        if (qms) lw = ms.quantize(lw);
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
        for (Rows it = rows0; it.row < Nz; it.next()) {
          if (b < B) {
            const float x = __ldg(llr + (size_t)it.row * B + b);
            const float base = qms ? ms.quantize(x) : x;
            app_out[(size_t)it.row * B + b] =
                clip(base + gr.bit_sum(c2v, it.q, it.r, gt), ms.clip_llr);
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
    if (vn_mode > 0 && t + 1 < T) stage_weights(w_vn, wv, t + 1, dim_vn);
    for (Rows it = rows0; it.row < Mz; it.next()) {
      const int g = gt;
      const int row = it.row, i = it.q, h = it.r;
      const int k0 = gr.cn_ptr[i], k1 = gr.cn_ptr[i + 1];
      float u = 0.0f;
      if (ucn || (kDep && t > 0)) {
        const int par = gr.check_parity(bits, i, h, g);
        u = (float)par;
        if (kDep && t > 0 && par) unsat_at[g] = t;  // all writers store t
      }
      // the check's weight this iteration (per edge: per slot, below)
      const float w_chk =
          (cn_mode > 0 && !per_edge) ? cn_w(wc, wu, cn_col(cn_mode, i, 0), ucn, u) : 1.0f;
      if (kSP) {
        // tanh of each V->C message, stashed in its own C->V slot, then
        // suffix products in suf[]; streaming, the pre-clip value goes out
        // before its slot is overwritten, and the UCN mask is the check's
        // one residual
        float suf[kMaxDegSP];
        if (stream && ucn && b < B)
          cres_w[((size_t)t * Mz + row) << lgW] = u;
        for (int q = k0; q < k1; ++q) {
          const int4 sd = gr.slot[q];
          const int sl = gr.sub(sd, h);
          const int ci = gr.at(sd.x + sl, g);
          const float pre = tot[gr.at(sd.y + sl, g)] - c2v[ci];
          if (stream && b < B)
            hist_w[((size_t)t * Ez + sd.x + sl) << lgW] = pre;
          const float x = ms.v2c(pre);
          const float v = tanhf(-0.5f * x);
          c2v[ci] = (v == 0.0f) ? 1.0f : v;
        }
        float acc = 1.0f;
        for (int q = k1 - 1; q >= k0; --q) {
          const int4 sd = gr.slot[q];
          const float v = c2v[gr.at(sd.x + gr.sub(sd, h), g)];
          suf[q - k0] = acc;
          acc = (q == k1 - 1) ? v : acc * v;
        }
        float pre = 1.0f;
        for (int q = k0; q < k1; ++q) {
          const int4 sd = gr.slot[q];
          const int ci = gr.at(sd.x + gr.sub(sd, h), g);
          const float v = c2v[ci];
          float prod = (q == k0) ? suf[0]
                       : ((q == k1 - 1) ? pre : pre * suf[q - k0]);
          pre = (q == k0) ? v : pre * v;
          prod = fminf(fmaxf(prod, -kSPClip), kSPClip);
          const float out = -2.0f * atanhf(prod);
          float wmag = fabsf(out);
          if (cn_mode > 0) {
            const float w = per_edge ? cn_w(wc, wu, q, ucn, u) : w_chk;
            wmag = offset_mode ? wmag - w : wmag * w;
          }
          wmag = (wmag > 0.0f) ? wmag : 0.0f;
          wmag = ms.out(wmag);
          const float so = (out > 0.0f) ? 1.0f : ((out < 0.0f) ? -1.0f : 0.0f);
          c2v[ci] = wmag * so;
        }
        continue;
      }
      // pass 1: each V->C message derived once, kept in its own C->V slot
      float m1 = kPadMag, m2 = kPadMag, sgn_tot = 1.0f;
      for (int q = k0; q < k1; ++q) {
        const int4 sd = gr.slot[q];
        const int sl = gr.sub(sd, h);
        const int ci = gr.at(sd.x + sl, g);
        const float pre = tot[gr.at(sd.y + sl, g)] - c2v[ci];
        if (stream && b < B)
          hist_w[((size_t)t * Ez + sd.x + sl) << lgW] = pre;
        const float x = ms.v2c(pre);
        c2v[ci] = x;
        const float a = (x == 0.0f) ? kPadMag : fabsf(x);
        m2 = fminf(m2, fmaxf(m1, a));
        m1 = fminf(m1, a);
        sgn_tot *= (x > 0.0f) ? -1.0f : 1.0f;
      }
      if (stream && b < B) {
        const size_t r0 = (size_t)t * R * Mz + row;
        cres_w[r0 << lgW] = m1;
        cres_w[(r0 + Mz) << lgW] = m2;
        cres_w[(r0 + 2 * Mz) << lgW] = -sgn_tot;
        if (ucn) cres_w[(r0 + 3 * Mz) << lgW] = u;
      }
      // pass 2: the extrinsic magnitude, weight, ReLU, quantize or clip
      for (int q = k0; q < k1; ++q) {
        const int4 sd = gr.slot[q];
        const int ci = gr.at(sd.x + gr.sub(sd, h), g);
        const float x = c2v[ci];
        const float a = (x == 0.0f) ? kPadMag : fabsf(x);
        const float sg = (x > 0.0f) ? -1.0f : 1.0f;
        float mag = (a == m1) ? m2 : m1;
        mag = (mag <= kEps) ? mag - kEps : mag;
        const float out = mag * (-(sgn_tot * sg));
        float wmag = mag;
        if (cn_mode > 0) {
          const float w = per_edge ? cn_w(wc, wu, q, ucn, u) : w_chk;
          wmag = offset_mode ? mag - w : mag * w;
        }
        wmag = (wmag > 0.0f) ? wmag : 0.0f;
        wmag = ms.out(wmag);
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
      for (Rows it = rows0; it.row < Mz; it.next())
        if (gr.check_parity(bits, it.q, it.r, gt)) unsat_at[gt] = T;
      __syncthreads();
    }
    if (tid < G && b < B) fail_out[b] = !frozen[tid] && unsat_at[tid] == T;
  }
}

// One launch of fused_nms_kernel<kMode, kSP> on `stream` with `smem` bytes
// of dynamic shared memory per block of G words.  Returns -2 when `smem`
// is not the layout's size, else cudaGetLastError() after the launch (0 =
// launched).
template <int kMode, bool kSP>
int launch(const void* llr, const void* w_cn, const void* w_ucn,
           const void* w_vn, const void* tab, void* app, void* err,
           void* nerr, void* iters, void* fail, void* hist, void* cres,
           int N, int M, int z, int E, int T, int B, int G, int W,
           int threads, int smem, int target, int t0, Msg ms, int cn_mode,
           int ucn, int vn_mode, int offset_mode, int dim_cn, int dim_vn,
           cudaStream_t stream) {
  if (smem != decode_smem_bytes(N, M, z, E, G, ucn, kMode == kDeploy)) return -2;
  cudaError_t st = cudaFuncSetAttribute(
      fused_nms_kernel<kMode, kSP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return (int)st;
  const int blocks = (B + G - 1) / G;
  fused_nms_kernel<kMode, kSP><<<blocks, threads, smem, stream>>>(
      (const float*)llr, (const float*)w_cn, (const float*)w_ucn,
      (const float*)w_vn, (const int*)tab, (float*)app, (uint8_t*)err,
      (int*)nerr, (int*)iters, (uint8_t*)fail, (float*)hist, (float*)cres,
      N, M, z, E, T, B, G, W, target, t0, ms, cn_mode, ucn, vn_mode,
      offset_mode, dim_cn, dim_vn);
  return (int)cudaGetLastError();
}

}  // namespace
