// Fused neural min-sum / neural BP training pair: forward (B4) and backward
// (B5).
//
// Replaces ldpc_error_floor_tpu/ops/pallas_train.py::FusedTrainKernel:
//   fused_nms_train_fwd  _fwd_kernel (:366, pl.pallas_call :1166)
//   fused_nms_train_bwd  _bwd_kernel (:652, pl.pallas_call :1238)
// for MS, QMS, MS_RAW and SP (B4-SP: the SP branch :527-563; B5-SP:
// _sp_check_bwd :235-353).  Their plain version is autograd through
// ops/fused_decoder.py::plain_iterations (the scan body of
// ldpc_error_floor_tpu/models/nms.py with the scan backend's gradient
// semantics); under QMS the forward agrees with it bit for bit.
//
// Forward.  The mode kTrain of the decode loop in csrc/fused_nms_kernel.cuh
// (the loop of B1, G words per block, their whole decoder state in shared
// memory), which also writes, per iteration, the residuals the backward
// needs, straight to device memory, batch fastest so that the G threads of
// a row write G consecutive words:
//   hist [T][E*z][B]      the pre-clip V->C message of every edge slot
//                         (slot e*z + s: edge e, lifted bit s);
//   cres [T][R*M*z][B]    per lifted check: min-sum min1, min2, the negated
//                         sign product, and (R = 4, with UCN) the UCN mask;
//                         SP the UCN mask alone (R = 1; no cres without
//                         UCN), since B5-SP recomputes the tanh products;
//   apps [T-t0][target*z][B]  the pre-clip APP for t >= t0 (the wrapper
//                         clips it for the primal output).
// Nothing is staged asynchronously, so no copy can read a buffer that is
// being rewritten (the JAX forward's ping-pong has such a race).  Without
// hist (forward only, no gradient wanted) only the APPs are written.
//
// Backward.  t = T-1..0 over the residuals, G words per block; the
// cotangent of every C->V message of those words stays in shared memory
// (gc, VN-aligned like the forward's state).  Per iteration:
//   CN phase, one thread per lifted check: the weighting chain's gradient
//     (sign of the output, ReLU and the inclusive STE/clip mask on the
//     weighted magnitude, the weight), then the extrinsic min's
//     tie-splitting backward (the reference's reduce_min gradient: ties
//     share equally), |x|'s gradient (+1 at 0, as JAX), the zero nudge
//     (gradient 1) and the inclusive STE/clip mask of the pre-clip V->C
//     message; the per-slot weight gradient goes to a second shared array;
//     SP (sp_check_bwd) instead rebuilds the check's tanh prefix and suffix
//     products from the V->C stream and runs their VJP (below);
//   VN phase, one thread per lifted bit: the V->C sum's transpose turns the
//     slot cotangents into those of the previous iteration's C->V messages,
//     plus the previous iteration's APP cotangent under its clip mask; the
//     VN-weight gradient through quantize_ste(llr * w).
// Weight gradients are reduced without atomics, in a fixed order: warps
// sum each edge's (or bit's) z*G slots of a block, one thread per weight
// column combines them and writes a [blocks][T][dim] partial, and a second
// kernel sums the partials over blocks.  Two launches on the same inputs
// give bit-identical gradients.
//
// What bounds it on an H100: the residual stream, ~0.2 MB per word at T=20,
// against on-chip work (~16 simple f32 operations per edge slot and
// iteration forward, ~37 backward; SP adds a tanhf and an atanhf per slot
// forward and again backward; chip_smoke.py::train_bound counts them);
// both kernels touch device memory once per slot and iteration (the
// backward reads the V->C stream twice, from L2 the second time, and
// derives each message twice).  The launches run on the caller's stream,
// allocate nothing and do not synchronise.  Rounding follows the scan
// decoder (rintf, IEEE division; the build uses -fmad=false).
//
// B5-SP.  Per lifted check of degree d, one thread, four passes over the
// check's edges in CN order and back, holding per slot the raw tanh, the
// prefix product F and the suffix product B in three arrays of kMaxDegSP
// floats in the thread's local memory (cached in L1; a third [E*z][G]
// shared array would halve G on most codes), and the inclusive clip mask of
// each pre-clip message in a 64-bit register:
//   1. forward: x = the clipped message, raw tanh(-x/2), F, exactly the
//      forward's operations (so p = F*B is the forward's product, bit for
//      bit, and the product clip's masks are the forward's);
//   2. backward: B;
//   3. forward: per edge the clip, -2 atanh, the weighting chain and its
//      gradient (the per-slot weight gradient to gw, as B5), g_p with the
//      half-gradient at an exactly hit clip bound; gF = g_p*B kept in B's
//      place; the suffix recurrence's reverse as a running sum, whose share
//      of each slot's tanh cotangent waits in the slot's gc;
//   4. backward: the prefix recurrence's reverse as a running sum, plus
//      the waiting share, through tanh's derivative on the raw value (the
//      additive zero->1 map has gradient 1) and the clip mask, into gc.
// No division anywhere (the plain version's cumprod backward divides).

#include "fused_nms_kernel.cuh"

namespace {

struct Cfg {
  int N, M, z, E, T, B, G, target, t0, Dc;
  int dec_type;
  float qstep, qclip, clip_llr;
  int cn_mode, ucn, vn_mode, offset_mode, dim_cn, dim_vn;

  __device__ bool qms() const { return dec_type == kQMS; }
  // The V->C message from its pre-clip value (the forward's v2c_msg).
  __device__ float msg(float pre) const {
    return v2c_msg(pre, dec_type, qstep, qclip, clip_llr);
  }
  // The clip of a V->C message and of a weighted magnitude: the QMS grid's
  // or clip_llr.
  __device__ float msg_clip() const { return qms() ? qclip : clip_llr; }
  __device__ int vn_col(int j) const {
    return (vn_mode == 2 || vn_mode == 5) ? j : 0;
  }
};

// ---- B5: backward --------------------------------------------------------

// Lane 0 gets the sum of the warp's values, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// B5-SP for lifted check (i, h) of word g (column b) at iteration t: turns
// the cotangents of its new C->V messages (gc, this thread's slots) into
// those of its pre-clip V->C messages, and writes the per-slot CN-weight
// gradient to gw (with CN weights).  u: the check's UCN mask.
__device__ void sp_check_bwd(const Cfg& c, const Graph& gr,
                             const float* __restrict__ hist,
                             const float* __restrict__ w_cn,
                             const float* __restrict__ w_ucn, float* gc,
                             float* gw, int t, int i, int h, int g, int b,
                             float u) {
  float ttr[kMaxDegSP], fp[kMaxDegSP], bs[kMaxDegSP];
  const int k0 = gr.cn_ptr[i], deg = gr.cn_ptr[i + 1] - k0;
  const int z = c.z;
  const bool cnw = c.cn_mode > 0;
  const size_t Ez = (size_t)c.E * z;
  auto slot = [&](int n) {  // the shared index of the check's n-th edge
    const int e = gr.cn_edge[k0 + n];
    return (e * z + (h + gr.edge_shift[e]) % z) * c.G + g;
  };
  auto tt_of = [](float v) { return (v == 0.0f) ? 1.0f : v; };
  // 1. the raw tanh of each message and the prefix products F
  unsigned long long inside = 0ull;  // bit n: |pre| <= clip_llr
  float a = 1.0f;
  for (int n = 0; n < deg; ++n) {
    const int e = gr.cn_edge[k0 + n];
    const int sl = (h + gr.edge_shift[e]) % z;
    const float pre =
        __ldg(hist + ((size_t)t * Ez + (size_t)e * z + sl) * c.B + b);
    if (fabsf(pre) <= c.clip_llr) inside |= 1ull << n;
    const float v = tanhf(-0.5f * c.msg(pre));
    ttr[n] = v;
    fp[n] = a;
    a = (n == 0) ? tt_of(v) : a * tt_of(v);
  }
  // 2. the suffix products B
  a = 1.0f;
  for (int n = deg - 1; n >= 0; --n) {
    bs[n] = a;
    a = (n == deg - 1) ? tt_of(ttr[n]) : a * tt_of(ttr[n]);
  }
  // 3. per edge: the product's clip and atanh, the weighting chain and its
  // gradient, g_p; gF = g_p*B replaces B; the running gB of the suffix
  // recurrence's reverse leaves its share of the slot's tanh cotangent in gc
  float gb = 0.0f;
  for (int n = 0; n < deg; ++n) {
    const int si = slot(n);
    const float F = fp[n], Bn = bs[n];
    const float p = F * Bn;
    const float pc = fminf(fmaxf(p, -kSPClip), kSPClip);
    const float out = -2.0f * atanhf(pc);
    const float mag = fabsf(out);
    const float so = (out > 0.0f) ? 1.0f : ((out < 0.0f) ? -1.0f : 0.0f);
    float w_eff = 1.0f, r = mag;
    if (cnw) {
      w_eff = cn_weight(w_cn, t, c.dim_cn, c.cn_mode, i, k0 + n);
      if (c.ucn) {
        const float wu = cn_weight(w_ucn, t, c.dim_cn, c.cn_mode, i, k0 + n);
        w_eff = w_eff * (1.0f - u) + wu * u;
      }
      r = c.offset_mode ? mag - w_eff : mag * w_eff;
    }
    // ReLU and the inclusive clip mask on the weighted magnitude: 0 < r <= clip
    const float g_in = (r > 0.0f && r <= c.clip_llr) ? gc[si] * so : 0.0f;
    const float g_mag = (cnw && !c.offset_mode) ? g_in * w_eff : g_in;
    if (cnw) gw[si] = c.offset_mode ? -g_in : g_in * mag;
    // |out| (gradient +1 at 0), -2 atanh, the clip: 1/2 at a hit bound
    const float g_out = g_mag * ((out >= 0.0f) ? 1.0f : -1.0f);
    const float g_pc = g_out * (-2.0f / (1.0f - pc * pc));
    const float in_hi = 0.5f * ((p < kSPClip ? 1.0f : 0.0f) +
                                (p <= kSPClip ? 1.0f : 0.0f));
    const float in_lo = 0.5f * ((p > -kSPClip ? 1.0f : 0.0f) +
                                (p >= -kSPClip ? 1.0f : 0.0f));
    const float g_p = g_pc * in_hi * in_lo;
    bs[n] = g_p * Bn;  // gF
    const float gbn = g_p * F;
    float share = 0.0f;
    if (n == 0) {
      gb = gbn;
    } else {
      share = gb * Bn;
      gb = gbn + gb * tt_of(ttr[n]);
    }
    gc[si] = share;
  }
  // 4. the running gF of the prefix recurrence's reverse; tanh(-x/2)'s
  // derivative on the raw value; the clip mask (a degree-1 check gets 0)
  float gf = 0.0f;
  for (int n = deg - 1; n >= 0; --n) {
    const int si = slot(n);
    float share = 0.0f;
    if (n == deg - 1) {
      gf = bs[n];
    } else {
      share = gf * fp[n];
      gf = bs[n] + gf * tt_of(ttr[n]);
    }
    const float g_tt = share + gc[si];
    const float g_x = g_tt * (-0.5f) * (1.0f - ttr[n] * ttr[n]);
    gc[si] = ((inside >> n) & 1ull) ? g_x : 0.0f;
  }
}

// Shared memory (ops/fused_train.py::_smem_bwd): slot cotangents float
// [E*z][G] | per-slot CN-weight gradients float [E*z][G] (CN weights) |
// per-bit VN-weight gradients float [N*z][G] (VN weights) | per-edge sums
// float [2][E] and per-VN sums float [N] | UCN masks uint8 [M*z][G] (UCN).
// kSP: the CN phase is SP's (sp_check_bwd).
template <bool kSP>
__global__ void __launch_bounds__(1024)
train_bwd_kernel(const float* __restrict__ llr, const float* __restrict__ w_cn,
                 const float* __restrict__ w_ucn,
                 const float* __restrict__ w_vn, const int* __restrict__ tab,
                 const float* __restrict__ hist, const float* __restrict__ cres,
                 const float* __restrict__ apps_pre,
                 const float* __restrict__ g_apps, float* __restrict__ part_cn,
                 float* __restrict__ part_ucn, float* __restrict__ part_vn,
                 Cfg c) {
  extern __shared__ float smem[];
  const int z = c.z, G = c.G, B = c.B, T = c.T;
  const int NzG = c.N * z * G, MzG = c.M * z * G, EzG = c.E * z * G;
  const int zG = z * G;
  const bool cnw = c.cn_mode > 0, vnw = c.vn_mode > 0;
  float* gc = smem;
  float* gw = gc + EzG;                    // used with CN weights
  float* gv = gw + (cnw ? EzG : 0);        // used with VN weights
  float* red_c = gv + (vnw ? NzG : 0);
  float* red_u = red_c + c.E;
  float* red_v = red_u + c.E;
  uint8_t* ucn_s = reinterpret_cast<uint8_t*>(red_v + c.N);
  const Graph gr(tab, c.N, c.M, c.E, z, G);
  const size_t Ez = (size_t)c.E * z, Mz = (size_t)c.M * z;
  const size_t Tz = (size_t)c.target * z;
  const int R = c.ucn ? 4 : 3;
  const float mclip = c.msg_clip();

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int gt = tid % G;
  const int b = blockIdx.x * G + gt;
  const bool real = b < B;

  // cotangent of iteration tt's clipped APP on lifted bit `row` (0 outside
  // the emission window, the target columns, or the clip)
  auto fold = [&](int tt, int row) -> float {
    if (tt < c.t0 || row >= c.target * z) return 0.0f;
    const size_t at = ((size_t)(tt - c.t0) * Tz + row) * B + b;
    const float ap = __ldg(apps_pre + at);
    return (ap >= -c.clip_llr && ap <= c.clip_llr) ? __ldg(g_apps + at) : 0.0f;
  };

  for (int k = tid; k < NzG; k += nthr) {
    const int row = k / G;
    const int j = row / z;
    const int s = row - j * z;
    const float f = real ? fold(T - 1, row) : 0.0f;
    for (int e = gr.vn_ptr[j]; e < gr.vn_ptr[j + 1]; ++e)
      gc[(e * z + s) * G + gt] = f;
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // ---- CN phase: per lifted check -----------------------------------
    for (int k = tid; k < MzG; k += nthr) {
      const int g = gt;
      const int row = k / G;
      const int i = row / z;
      const int h = row - i * z;
      const int k0 = gr.cn_ptr[i], k1 = gr.cn_ptr[i + 1];
      if (!real) {  // a ragged block's missing words contribute nothing
        for (int q = k0; q < k1; ++q) {
          const int e = gr.cn_edge[q];
          const int si = (e * z + (h + gr.edge_shift[e]) % z) * G + g;
          gc[si] = 0.0f;
          if (cnw) gw[si] = 0.0f;
        }
        if (c.ucn) ucn_s[k] = 0;
        continue;
      }
      if (kSP) {
        const float u =
            c.ucn ? __ldg(cres + ((size_t)t * Mz + row) * B + b) : 0.0f;
        if (c.ucn) ucn_s[k] = u > 0.5f;
        sp_check_bwd(c, gr, hist, w_cn, w_ucn, gc, gw, t, i, h, g, b, u);
        continue;
      }
      const size_t r0 = (size_t)t * R * Mz + row;
      const float m1 = __ldg(cres + r0 * B + b);
      const float m2 = __ldg(cres + (r0 + Mz) * B + b);
      const float neg_tot = __ldg(cres + (r0 + 2 * Mz) * B + b);
      const float u = c.ucn ? __ldg(cres + (r0 + 3 * Mz) * B + b) : 0.0f;
      if (c.ucn) ucn_s[k] = u > 0.5f;
      // pass 1: the weighting chain, per edge; tie counts and sums
      float c1 = 0.0f, c2 = 0.0f, g_above = 0.0f, g_min = 0.0f;
      for (int q = k0; q < k1; ++q) {
        const int e = gr.cn_edge[q];
        const int sl = (h + gr.edge_shift[e]) % z;
        const int si = (e * z + sl) * G + g;
        const float x =
            c.msg(__ldg(hist + ((size_t)t * Ez + (size_t)e * z + sl) * B + b));
        const float a = (x == 0.0f) ? kPadMag : fabsf(x);
        const float sg = (x > 0.0f) ? -1.0f : 1.0f;
        const float mag = (a == m1) ? m2 : m1;
        const float magp = (fabsf(mag) <= kEps) ? mag - kEps : mag;
        // sign(out), out = magp * (neg_tot * sg)
        const float so =
            ((magp > 0.0f) ? 1.0f : ((magp < 0.0f) ? -1.0f : 0.0f)) *
            (neg_tot * sg);
        float w_eff = 1.0f, r = magp;
        if (cnw) {
          w_eff = cn_weight(w_cn, t, c.dim_cn, c.cn_mode, i, q);
          if (c.ucn) {
            const float wu = cn_weight(w_ucn, t, c.dim_cn, c.cn_mode, i, q);
            w_eff = w_eff * (1.0f - u) + wu * u;
          }
          r = c.offset_mode ? magp - w_eff : magp * w_eff;
        }
        // ReLU (gradient 0 at 0) and the inclusive mask of the STE/clip on
        // its output collapse to 0 < r <= clip
        const float g_r = (r > 0.0f && r <= mclip) ? gc[si] * so : 0.0f;
        const float g_mag = (cnw && !c.offset_mode) ? g_r * w_eff : g_r;
        if (cnw) gw[si] = c.offset_mode ? -g_r : g_r * magp;
        gc[si] = g_mag;
        if (a == m1) {
          c1 += 1.0f;
          g_min += g_mag;
        } else {
          g_above += g_mag;
        }
        if (a == m2) c2 += 1.0f;
      }
      // the padded slots of a check below the largest degree sit at kPadMag
      const float npad = (float)(c.Dc - (k1 - k0));
      if (m1 == kPadMag) c1 += npad;
      if (m2 == kPadMag) c2 += npad;
      c2 = fmaxf(c2, 1.0f);
      const bool multi = c1 > 1.0f;
      // pass 2: the tie-splitting extrinsic-min backward, |x|, the nudge
      // (gradient 1) and the inclusive mask of the V->C quantizer/clip
      for (int q = k0; q < k1; ++q) {
        const int e = gr.cn_edge[q];
        const int sl = (h + gr.edge_shift[e]) % z;
        const int si = (e * z + sl) * G + g;
        const float pre =
            __ldg(hist + ((size_t)t * Ez + (size_t)e * z + sl) * B + b);
        const float x = c.msg(pre);
        const float a = (x == 0.0f) ? kPadMag : fabsf(x);
        float ga = 0.0f;
        if (a == m1)
          ga = multi ? g_above / c1 + (g_min - gc[si]) / fmaxf(c1 - 1.0f, 1.0f)
                     : g_above;
        else if (a == m2)
          ga = multi ? 0.0f : g_min / c2;
        const float gx = (x >= 0.0f) ? ga : -ga;
        gc[si] = (fabsf(pre) <= mclip) ? gx : 0.0f;
      }
    }
    __syncthreads();

    // ---- CN-weight sums per edge; VN phase: per lifted bit ------------
    if (cnw) {
      for (int e = warp; e < c.E; e += nwarps) {
        const int i = gr.edge_cn[e], sh = gr.edge_shift[e];
        float sc = 0.0f, su = 0.0f;
        for (int idx = lane; idx < zG; idx += 32) {
          const float v = gw[e * zG + idx];
          const int s = idx / G, g = idx - s * G;
          if (c.ucn && ucn_s[(i * z + (s - sh + z) % z) * G + g])
            su += v;
          else
            sc += v;
        }
        sc = warp_sum(sc);
        su = warp_sum(su);
        if (lane == 0) {
          red_c[e] = sc;
          red_u[e] = su;
        }
      }
    }
    for (int k = tid; k < NzG; k += nthr) {
      const int row = k / G;
      const int j = row / z;
      const int s = row - j * z;
      const int e0 = gr.vn_ptr[j], e1 = gr.vn_ptr[j + 1];
      if (!real) {
        for (int e = e0; e < e1; ++e) gc[(e * z + s) * G + gt] = 0.0f;
        if (vnw) gv[k] = 0.0f;
        continue;
      }
      const float g_tot = gr.bit_sum(gc, j, s, gt);
      if (vnw) {
        const float x = __ldg(llr + (size_t)row * B + b);
        const float lw =
            x * __ldg(w_vn + (size_t)t * c.dim_vn + c.vn_col(j));
        const bool inside = !c.qms() || fabsf(lw) <= c.qclip;
        gv[k] = (inside ? g_tot : 0.0f) * x;
      }
      if (t > 0) {
        const float f = fold(t - 1, row);
        for (int e = e0; e < e1; ++e) {
          const int si = (e * z + s) * G + gt;
          gc[si] = (g_tot - gc[si]) + f;
        }
      }
    }
    __syncthreads();

    // ---- weight-gradient partials of this block and iteration ---------
    const size_t pb = (size_t)blockIdx.x * T + t;
    if (cnw) {
      for (int d = tid; d < c.dim_cn; d += nthr) {
        float vc, vu;
        if (c.cn_mode == 1 || c.cn_mode == 4) {
          vc = red_c[gr.cn_edge[d]];
          vu = red_u[gr.cn_edge[d]];
        } else {
          const bool per_check = c.cn_mode == 2 || c.cn_mode == 5;
          const int q0 = per_check ? gr.cn_ptr[d] : 0;
          const int q1 = per_check ? gr.cn_ptr[d + 1] : c.E;
          vc = red_c[gr.cn_edge[q0]];
          vu = red_u[gr.cn_edge[q0]];
          for (int q = q0 + 1; q < q1; ++q) {
            vc += red_c[gr.cn_edge[q]];
            vu += red_u[gr.cn_edge[q]];
          }
        }
        part_cn[pb * c.dim_cn + d] = vc;
        if (c.ucn) part_ucn[pb * c.dim_cn + d] = vu;
      }
    }
    if (vnw) {
      for (int j = warp; j < c.N; j += nwarps) {
        float sv = 0.0f;
        for (int idx = lane; idx < zG; idx += 32) sv += gv[j * zG + idx];
        sv = warp_sum(sv);
        if (lane == 0) red_v[j] = sv;
      }
      __syncthreads();
      for (int d = tid; d < c.dim_vn; d += nthr) {
        float v = red_v[d];
        if (c.vn_mode == 3)
          for (int j = 1; j < c.N; ++j) v += red_v[j];
        part_vn[pb * c.dim_vn + d] = v;
      }
    }
    __syncthreads();
  }
}

// out[col] = sum over blocks of part[block][col], in a fixed order: thread
// (x, y) sums blocks y, y+8, ... of column blockIdx.x*32 + x, then row 0
// adds the eight sums in order.
__global__ void reduce_partials(const float* __restrict__ part,
                                float* __restrict__ out, int nblk, int cols) {
  __shared__ float acc[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (col < cols)
    for (int k = threadIdx.y; k < nblk; k += 8) s += part[(size_t)k * cols + col];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float v = acc[0][threadIdx.x];
    for (int y = 1; y < 8; ++y) v += acc[y][threadIdx.x];
    out[col] = v;
  }
}

int reduce(const void* part, void* out, int nblk, int cols,
           cudaStream_t stream) {
  if (out == nullptr || cols == 0) return 0;
  reduce_partials<<<(cols + 31) / 32, dim3(32, 8), 0, stream>>>(
      (const float*)part, (float*)out, nblk, cols);
  return (int)cudaGetLastError();
}

Cfg make_cfg(int N, int M, int z, int E, int T, int B, int G, int target,
             int t0, int Dc, int dec_type, float qstep, float qclip,
             float clip_llr, int cn_mode, int ucn, int vn_mode,
             int offset_mode, int dim_cn, int dim_vn) {
  Cfg c;
  c.N = N; c.M = M; c.z = z; c.E = E; c.T = T; c.B = B; c.G = G;
  c.target = target; c.t0 = t0; c.Dc = Dc; c.dec_type = dec_type;
  c.qstep = qstep; c.qclip = qclip; c.clip_llr = clip_llr;
  c.cn_mode = cn_mode; c.ucn = ucn; c.vn_mode = vn_mode;
  c.offset_mode = offset_mode; c.dim_cn = dim_cn; c.dim_vn = dim_vn;
  return c;
}

}  // namespace

#define TRAIN_CFG_ARGS                                                      \
  int N, int M, int z, int E, int T, int B, int G, int threads, int smem,   \
      int target, int t0, int Dc, int dec_type, float qstep, float qclip,   \
      float clip_llr, int cn_mode, int ucn, int vn_mode, int offset_mode,   \
      int dim_cn, int dim_vn
#define TRAIN_CFG                                                           \
  make_cfg(N, M, z, E, T, B, G, target, t0, Dc, dec_type, qstep, qclip,     \
           clip_llr, cn_mode, ucn, vn_mode, offset_mode, dim_cn, dim_vn)

// B4: fused_nms_kernel<kTrain, SP?>.  Writes apps [T-t0][target*z][B]
// (pre-clip) and, when hist is not null, hist [T][E*z][B] and cres
// [T][R*M*z][B] (null for SP without UCN).  `smem` is one block's dynamic
// shared memory (ops/fused_decoder.py::_smem_bytes).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_nms_train_fwd_launch(
    const void* llr, const void* w_cn, const void* w_ucn, const void* w_vn,
    const void* tab, void* apps, void* hist, void* cres, TRAIN_CFG_ARGS,
    void* stream) {
  (void)Dc;
#define TRAIN_FWD_LAUNCH(SP)                                                  \
  launch<kTrain, SP>(llr, w_cn, w_ucn, w_vn, tab, apps, nullptr, nullptr,     \
                     nullptr, nullptr, hist, cres, N, M, z, E, T, B, G,       \
                     threads, smem, target, t0, dec_type, qstep, qclip,       \
                     clip_llr, cn_mode, ucn, vn_mode, offset_mode, dim_cn,    \
                     dim_vn, (cudaStream_t)stream)
  return dec_type == kSPDec ? TRAIN_FWD_LAUNCH(true) : TRAIN_FWD_LAUNCH(false);
#undef TRAIN_FWD_LAUNCH
}

// B5 (B5-SP for dec_type SP).  Reads the forward's residuals and the APP
// cotangent g_apps (same layout as apps), writes the partials part_* [blocks][T][dim] (scratch)
// and the weight gradients g_* [T][dim] (null for a kind without weights).
extern "C" int fused_nms_train_bwd_launch(
    const void* llr, const void* w_cn, const void* w_ucn, const void* w_vn,
    const void* tab, const void* hist, const void* cres,
    const void* apps_pre, const void* g_apps, void* part_cn, void* part_ucn,
    void* part_vn, void* g_cn, void* g_ucn, void* g_vn, TRAIN_CFG_ARGS,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto* kernel = dec_type == kSPDec ? train_bwd_kernel<true>
                                    : train_bwd_kernel<false>;
  cudaError_t st = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return (int)st;
  const int blocks = (B + G - 1) / G;
  kernel<<<blocks, threads, smem, s>>>(
      (const float*)llr, (const float*)w_cn, (const float*)w_ucn,
      (const float*)w_vn, (const int*)tab, (const float*)hist,
      (const float*)cres, (const float*)apps_pre, (const float*)g_apps,
      (float*)part_cn, (float*)part_ucn, (float*)part_vn, TRAIN_CFG);
  int rc = (int)cudaGetLastError();
  if (rc == 0) rc = reduce(part_cn, g_cn, blocks, T * dim_cn, s);
  if (rc == 0) rc = reduce(part_ucn, g_ucn, blocks, T * dim_cn, s);
  if (rc == 0) rc = reduce(part_vn, g_vn, blocks, T * dim_vn, s);
  return rc;
}
