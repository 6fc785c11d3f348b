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
// needs, straight to device memory, in a layout private to the pair: tiles
// of W words, W the backward's G, the last tile padded:
//   hist [tiles][T][E*z][W]    the pre-clip V->C message of every edge slot
//                              (slot e*z + s: edge e, lifted bit s);
//   cres [tiles][T][R*M*z][W]  per lifted check: min-sum min1, min2, the
//                              negated sign product, and (R = 4, with UCN)
//                              the UCN mask; SP the UCN mask alone (R = 1;
//                              no cres without UCN), since B5-SP recomputes
//                              the tanh products;
//   apps [T-t0][target*z][B]   the pre-clip APP for t >= t0 (the wrapper
//                              clips it for the primal output; the loss
//                              reads it, so it keeps the batch-minor
//                              layout);
//   last [(N-target)*z][B]     under a systematic target, when asked for
//                              (the instance with kExtra 1), the last
//                              iteration's pre-clip APP of the other rows,
//                              so that the caller has its whole APP (the
//                              scan decoder's app_last).
// One backward block's residuals of one iteration are then one contiguous
// run (on wman at W = 4: 33,792 bytes of hist and 6,912 of cres).  Without
// hist (forward only, no gradient wanted) only the APPs are written.
//
// Backward.  t = T-1..0 over the residuals, G = W words per block; the
// cotangent of every C->V message of those words stays in shared memory
// (gc, VN-aligned like the forward's state).  Per iteration:
//   CN phase, one thread per lifted check: the weighting chain's gradient
//     (sign of the output, ReLU and the inclusive STE/clip mask on the
//     weighted magnitude, the weight), then the extrinsic min's
//     tie-splitting backward (the reference's reduce_min gradient: ties
//     share equally), |x|'s gradient (+1 at 0, as JAX), the zero nudge
//     (gradient 1) and the inclusive STE/clip mask of the pre-clip V->C
//     message.  Each message is derived once: the first pass writes it (or,
//     outside the clip, a flag) over its pre-clip value in the staged tile,
//     the second reads it back.  SP (sp_check_bwd) instead rebuilds the
//     check's tanh prefix and suffix products from the V->C stream and runs
//     their VJP (below);
//   VN phase, one thread per lifted bit: the V->C sum's transpose turns the
//     slot cotangents into those of the previous iteration's C->V messages,
//     plus the previous iteration's APP cotangent under its clip mask; the
//     VN-weight gradient through quantize_ste(llr * w).
// The last iteration's APP cotangent enters before the loop, on every bit:
// the window's on the target rows and, when given (g_last), that of the
// last APP's rows past the target, each under its clip mask.
// What bounds it on an H100 is latency, not bytes (it moves ~6.9 GB per
// launch at batch 32768 on the base block, 2.06 ms at 3.35 TB/s): serial
// slot loops, shared-memory round trips and three block-wide barriers per
// iteration, with few warps per SM to hide them.  What the design does
// (the min-sum types; B5-SP shares the staging and the weight sums):
//   - one thread issues Hopper's bulk asynchronous copy (cp.async.bulk,
//     completing on an mbarrier; no tensor map) of a whole iteration's
//     residual run into shared memory, and the CN phase reads the stream
//     from there only.  The copy of iteration t - 1 goes out as soon as the
//     CN phase of t is done with the buffer, so it overlaps the weight sums
//     and the VN phase of t.  One buffer: two fit the base block, wman
//     (3,0,3), at G = 8 (232,352 bytes) but measured 4% slower there (16.4
//     against 17.1 ms at batch 32768 on an H100; they leave the SM 24 KB of
//     L1), and the post block (UCN) has room for one only;
//   - the weight gradients need no per-slot array under scalar or
//     per-check CN sharing (modes 3, 2, 5) and scalar VN sharing: a check's
//     (bit's) thread owns all of its contributions to a weight, so it sums
//     them in registers, CN and UCN apart by the check's mask.  A check's
//     sums go to one value per lifted check and word, which a warp per
//     check sums in lane order (scalar sharing then adds the checks' sums
//     in check order); a bit's scalar sums go through warp shuffles and
//     then per-warp values summed in warp order.  The per-edge modes 1 and
//     4 keep the per-slot array gw and its per-edge warp sums, the per-VN
//     modes 2 and 5 the per-bit array gv.  That frees the shared memory the
//     staged tiles take.  Measured on wman at batch 32768 on an H100:
//     per-check sharing (2,2,2) 11.6 ms against 16.8 with gw (G = 4
//     against 2, the most words whose two blocks fit with gw); scalar
//     sharing as fast as with the CN sums in registers (within 0.6%), with
//     one strategy less, though the per-check values halve G on MacKay
//     (3,3,3) and Polar (3,0,3);
//   - the graph table and each iteration's weights sit in shared memory,
//     and the quantizer multiplies by 1/step, as in the forward;
//   - two blocks share an SM: the launch bound caps a thread at 56
//     registers (576 threads, two blocks), and the wrapper takes the most
//     words whose two blocks fit the SM's shared memory (wman: G = 4,
//     80,800 bytes on the base block; 26% faster than one block of G = 8,
//     which held the SM's registers at 64 a thread).  The forward runs two
//     blocks per SM as well (kTrain, G = 8 on wman).
// Every sum runs in a fixed order into [blocks][T][dim] partials, and a
// second kernel sums the partials over blocks, so two launches on the same
// inputs give bit-identical gradients.  The launches run on the caller's
// stream, allocate nothing and do not synchronise.  Rounding follows the
// scan decoder (rintf; the build uses -fmad=false).
//
// B5-SP.  Per lifted check of degree d, one thread; the staged run and the
// weight sums as B5's (above), the slot rows from the lifted slot table
// (`stage_lifted`), and no local array: a slot keeps its raw tanh over its
// pre-clip value in the staged run, its cotangent in gc, and one value in a
// register of one chunk of kSPRegDeg slots (bq), another chunk's products
// formed again from values kept at its boundaries (in registers: the suffix
// product above the chunk, the prefix product and the running gB below
// it).  The clip mask of each pre-clip message stays in a 64-bit register.
// The passes, in CN order and back:
//   A. reverse: x = the clipped message, its raw tanh(-x/2) (over the
//      pre-clip value), the suffix products B into bq, exactly the
//      forward's operations (so p = F*B is the forward's product, bit for
//      bit, and the product clip's masks are the forward's);
//   B. forward: the prefix products F; per edge the clip, -2 atanh, the
//      weighting chain and its gradient, g_p with the half-gradient at an
//      exactly hit clip bound; gF = g_p*B in B's register; the suffix
//      recurrence's reverse as a running sum gB, whose share of each slot's
//      tanh cotangent waits in gc (an earlier chunk, whose registers the
//      next chunk takes, leaves g_p in gc instead);
//   C. per chunk, last to first: an earlier chunk's gF and shares formed
//      again (B from its top, F and gB from its bottom, g_p from gc); a
//      reverse pass, the prefix recurrence's reverse as a running sum gF,
//      each slot's register taking the running value above it; a forward
//      pass that forms F again and adds the share (that value times F) to
//      the waiting one, then tanh's derivative on the raw value (the
//      additive zero->1 map has gradient 1) and the clip mask, into gc.
// Every product and sum is the one that four passes over per-slot arrays
// of kMaxDegSP floats in local memory (this kernel's earlier form) gave (a
// CPU test, tests/test_torch_kernel_layout.py, emulates both orders), so
// each slot's cotangent and per-slot CN-weight gradient did not move; the
// scalar and per-check weight sums run in B5's order.  Checks of one chunk
// (kChunks = 1, as on wman) take an instance without the chunk boundaries,
// under SP's launch bound (80 registers, where it does not spill; at the
// pair's 56 it spilled 56 bytes and ran 19% faster with 1,152 threads per
// SM against 768); the wide instance spills at either bound and runs under
// the pair's, where it was 23% faster on 802.11n.  Measured on wman at
// batch 32768 on an H100 (the earlier form: 19.5 ms): per-slot weight sums
// instead of B5's +34%, a synchronous copy instead of the bulk one +24%; a
// third [E*z][G] array (for F) halved G on 802.11n.
// No division anywhere (the plain version's cumprod backward divides).

#include "fused_nms_kernel.cuh"

namespace {

// How B5 reduces a kind's weight gradient: no weights; one value per slot
// (gw) or per bit (gv) summed by warps; one value per lifted check and word
// (scalar and per-check CN modes); register sums (scalar VN mode).
constexpr int kNoSum = 0;
constexpr int kPerSlot = 1;
constexpr int kPerItem = 2;
constexpr int kInRegs = 3;

struct Cfg {
  int N, M, z, E, T, B, G, target, t0, Dc;
  Msg ms;
  int cn_mode, ucn, vn_mode, offset_mode, dim_cn, dim_vn;

  __host__ __device__ int cn_sum() const {
    if (cn_mode == 0) return kNoSum;
    return (cn_mode == 1 || cn_mode == 4) ? kPerSlot : kPerItem;
  }
  __host__ __device__ int vn_sum() const {
    if (vn_mode == 0) return kNoSum;
    return vn_mode != 3 ? kPerSlot : kInRegs;
  }
  // check residuals per lifted check and iteration
  __host__ __device__ int R(bool sp) const {
    if (sp) return ucn ? 1 : 0;
    return ucn ? 4 : 3;
  }
  __device__ int vn_col(int j) const {
    return (vn_mode == 2 || vn_mode == 5) ? j : 0;
  }
};

// Byte offsets of B5's shared memory (ops/fused_train.py::_smem_bwd
// computes the same): graph table | the mbarrier uint64 (16 bytes) |
// weights float [2*dim_cn + dim_vn] (rounded to 16 bytes) | SP: the lifted
// slot table int2 [E*z] | the staged run float [E*z + R*M*z][G] | slot
// cotangents gc float [E*z][G] | per slot: gw float [E*z][G] | per bit: gv
// float [N*z][G] | per item: float [2][M*z][G] | per slot: per-edge sums
// float [2][E] | per bit: per-VN sums float [N] | per-warp sums float [32] |
// per slot with UCN: UCN masks uint8 [M*z][G].  end is the total.
struct BwdLayout {
  int bar, w, lifted, stage, gc, gw, gv, item, red, red_v, wsum, ucn_s, end;

  __host__ __device__ BwdLayout(const Cfg& c, bool sp) {
    const int EzG = c.E * c.z * c.G, NzG = c.N * c.z * c.G;
    const int MzG = c.M * c.z * c.G;
    const int cs = c.cn_sum(), vs = c.vn_sum();
    int o = table_bytes(c.N, c.M, c.E);
    bar = o;
    o += 16;
    w = o;
    o += 4 * ((2 * c.dim_cn + c.dim_vn + 3) & ~3);
    lifted = o;
    o += sp ? 8 * c.E * c.z : 0;
    stage = o;
    o += 4 * (EzG + c.R(sp) * MzG);
    gc = o;
    o += 4 * EzG;
    gw = o;
    o += cs == kPerSlot ? 4 * EzG : 0;
    gv = o;
    o += vs == kPerSlot ? 4 * NzG : 0;
    item = o;
    o += cs == kPerItem ? 8 * MzG : 0;
    red = o;
    o += cs == kPerSlot ? 8 * c.E : 0;
    red_v = o;
    o += vs == kPerSlot ? 4 * c.N : 0;
    wsum = o;
    o += 4 * 32;
    ucn_s = o;
    o += (cs == kPerSlot && c.ucn) ? MzG : 0;
    end = o;
  }
};

// ---- B5: backward --------------------------------------------------------

// Lane 0 gets the sum of the warp's values, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The staging of the residual runs, by one thread: arm the mbarrier (one
// arrival per phase), ...
__device__ __forceinline__ void init_stage_bar(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ... copy one iteration's hist run (hbytes) and cres run (cbytes, 0 for SP
// without UCN) of this block into shared memory at dst with Hopper's bulk
// asynchronous copy, completing on `bar` (sizes multiples of 16 bytes,
// addresses 16-byte aligned: the wrapper checks).  The proxy fence orders
// the CN phase's writes into the buffer before the copy overwrites it.
__device__ __forceinline__ void stage_tiles(float* dst, const float* hist,
                                            unsigned hbytes, const float* cres,
                                            unsigned cbytes, uint64_t* bar) {
  const unsigned b = smem_u32(bar);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(hbytes + cbytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(hist), "r"(hbytes), "r"(b)
      : "memory");
  if (cbytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst + hbytes / 4)),
        "l"(cres), "r"(cbytes), "r"(b)
        : "memory");
}

// ... and every thread waits for the copy's phase `parity` of `bar`.  A copy
// that never lands fails the launch (after ~2^24 polls, seconds) instead of
// hanging the card.
__device__ __forceinline__ void wait_tiles(uint64_t* bar, unsigned parity) {
  unsigned done = 0, polls = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (++polls == (1u << 24)) __trap();
  } while (!done);
}

// A register array indexed by a value the compiler cannot see: unrolled
// compares (no local memory).
template <int N>
__device__ __forceinline__ float reg_get(const float (&a)[N], int i) {
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (q == i) v = a[q];
  return v;
}
template <int N>
__device__ __forceinline__ void reg_set(float (&a)[N], int i, float v) {
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (q == i) a[q] = v;
}

// B5-SP for lifted check (i, h) of word g at iteration t, its d slots in
// CN order from check-order position k0, slot j's messages at the shared
// index row(j): turns the cotangents of its new C->V messages (gc, this
// thread's slots) into those of its pre-clip V->C messages.  ts: this
// block's staged V->C run of iteration t ([E*z][G]), whose entries of
// these slots the first pass replaces with their raw tanh; wc, wu: the
// iteration's CN and UCN weights; u: the check's UCN mask.  With
// `per_slot` (per-edge CN weights) each slot's CN-weight gradient goes to
// gw; returns their sum in slot order (0 without CN weights).  kChunks:
// the check has at most kChunks chunks of kSPRegDeg slots.  The passes are
// in the notes above.
template <int kChunks, class Row>
__device__ float sp_check_bwd(const Cfg& c, Row row, float* ts, float* gc,
                              float* gw, bool per_slot, const float* wc,
                              const float* wu, int i, int k0, int d, float u) {
  const bool cnw = c.cn_mode > 0;
  const bool per_edge = c.cn_mode == 1 || c.cn_mode == 4;
  const float w_chk =
      (cnw && !per_edge) ? cn_w(wc, wu, cn_col(c.cn_mode, i, 0), c.ucn, u) : 1.0f;
  auto tt_of = [](float v) { return (v == 0.0f) ? 1.0f : v; };
  const int C = kChunks > 1 ? (d - 1) / kSPRegDeg : 0;  // the last chunk
  // registers: one chunk's suffix products B (then gF = g_p*B, then the
  // running gF above each slot); at chunk c's boundaries (kChunks > 1):
  // top[c] the suffix product above chunk c < C, bot[c - 1] and gbot[c - 1]
  // the prefix product and the running gB below chunk c >= 1
  constexpr int kBounds = kChunks > 1 ? kChunks - 1 : 1;
  float bq[kSPRegDeg];
  float top[kBounds], bot[kBounds], gbot[kBounds];
  unsigned long long inside = 0ull;  // bit j: |pre| <= clip_llr

  // A. reverse: each slot's clip bit and raw tanh (over its pre-clip value),
  // the suffix products
  float acc = 1.0f;
  for (int cc = C; cc >= 0; --cc) {
    if (cc < C) reg_set(top, cc, acc);
#pragma unroll
    for (int ii = kSPRegDeg - 1; ii >= 0; --ii) {
      const int j = cc * kSPRegDeg + ii;
      if (j < d) {
        float* p = ts + row(j);
        const float pre = *p;
        if (fabsf(pre) <= c.ms.clip_llr) inside |= 1ull << j;
        const float v = tanhf(-0.5f * c.ms.v2c(pre));
        *p = v;
        bq[ii] = acc;
        acc = (j == d - 1) ? tt_of(v) : acc * tt_of(v);
      }
    }
  }

  // B. forward: the prefix products; per slot the product's clip and atanh,
  // the weighting chain and its gradient, g_p with the half-gradient at an
  // exactly hit clip bound; the running gB of the suffix recurrence's
  // reverse.  Chunk C keeps gF in registers and leaves each slot's share of
  // its tanh cotangent in gc; an earlier chunk leaves g_p in gc.
  float a = 1.0f, gb = 0.0f, sw = 0.0f;
  for (int cc = 0; cc <= C; ++cc) {
    if (cc > 0) {  // the chunk's suffix products again, from its top
      reg_set(bot, cc - 1, a);
      reg_set(gbot, cc - 1, gb);
      float s = (cc < C) ? reg_get(top, cc) : 1.0f;
#pragma unroll
      for (int ii = kSPRegDeg - 1; ii >= 0; --ii) {
        const int j = cc * kSPRegDeg + ii;
        if (j < d) {
          const float v = tt_of(ts[row(j)]);
          bq[ii] = s;
          s = (j == d - 1) ? v : s * v;
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < kSPRegDeg; ++ii) {
      const int j = cc * kSPRegDeg + ii;
      if (j < d) {
        const int si = row(j);
        const float tv = tt_of(ts[si]);
        const float F = a, Bn = bq[ii];
        a = (j == 0) ? tv : a * tv;
        const float p = F * Bn;
        const float pc = fminf(fmaxf(p, -kSPClip), kSPClip);
        const float out = -2.0f * atanhf(pc);
        const float mag = fabsf(out);
        const float so = (out > 0.0f) ? 1.0f : ((out < 0.0f) ? -1.0f : 0.0f);
        float w_eff = 1.0f, r = mag;
        if (cnw) {
          w_eff = per_edge ? cn_w(wc, wu, k0 + j, c.ucn, u) : w_chk;
          r = c.offset_mode ? mag - w_eff : mag * w_eff;
        }
        // ReLU and the inclusive clip mask on the weighted magnitude
        const float g_in = (r > 0.0f && r <= c.ms.clip_llr) ? gc[si] * so : 0.0f;
        const float g_mag = (cnw && !c.offset_mode) ? g_in * w_eff : g_in;
        if (cnw) {
          const float gwv = c.offset_mode ? -g_in : g_in * mag;
          if (per_slot)
            gw[si] = gwv;
          else
            sw += gwv;
        }
        // |out| (gradient +1 at 0), -2 atanh, the clip: 1/2 at a hit bound
        const float g_out = g_mag * ((out >= 0.0f) ? 1.0f : -1.0f);
        const float g_pc = g_out * (-2.0f / (1.0f - pc * pc));
        const float in_hi = 0.5f * ((p < kSPClip ? 1.0f : 0.0f) +
                                    (p <= kSPClip ? 1.0f : 0.0f));
        const float in_lo = 0.5f * ((p > -kSPClip ? 1.0f : 0.0f) +
                                    (p >= -kSPClip ? 1.0f : 0.0f));
        const float g_p = g_pc * in_hi * in_lo;
        const float gbn = g_p * F;
        float share = 0.0f;
        if (j == 0) {
          gb = gbn;
        } else {
          share = gb * Bn;
          gb = gbn + gb * tv;
        }
        bq[ii] = g_p * Bn;  // gF
        gc[si] = (cc == C) ? share : g_p;
      }
    }
  }

  // C. per chunk, last to first: an earlier chunk's gF and shares formed
  // again (B from its top, F and gB from its bottom, g_p from gc); the
  // reverse: the running gF of the prefix recurrence's reverse, each slot's
  // value above it kept in its register; the forward: F again, the share
  // gF*F, tanh(-x/2)'s derivative on the raw value (the additive zero->1
  // map has gradient 1) and the clip mask (a degree-1 check gets 0)
  float gf = 0.0f;
  for (int cc = C; cc >= 0; --cc) {
    const float f0 = (cc > 0) ? reg_get(bot, cc - 1) : 1.0f;
    if (cc < C) {
      float s = reg_get(top, cc);
#pragma unroll
      for (int ii = kSPRegDeg - 1; ii >= 0; --ii) {
        const int j = cc * kSPRegDeg + ii;
        if (j < d) {
          const float v = tt_of(ts[row(j)]);
          bq[ii] = s;
          s = (j == d - 1) ? v : s * v;
        }
      }
      float aa = f0, gg = (cc > 0) ? reg_get(gbot, cc - 1) : 0.0f;
#pragma unroll
      for (int ii = 0; ii < kSPRegDeg; ++ii) {
        const int j = cc * kSPRegDeg + ii;
        if (j < d) {
          const int si = row(j);
          const float tv = tt_of(ts[si]);
          const float F = aa, Bn = bq[ii], g_p = gc[si];
          aa = (j == 0) ? tv : aa * tv;
          const float gbn = g_p * F;
          float share = 0.0f;
          if (j == 0) {
            gg = gbn;
          } else {
            share = gg * Bn;
            gg = gbn + gg * tv;
          }
          bq[ii] = g_p * Bn;
          gc[si] = share;
        }
      }
    }
#pragma unroll
    for (int ii = kSPRegDeg - 1; ii >= 0; --ii) {
      const int j = cc * kSPRegDeg + ii;
      if (j < d) {
        const float gF = bq[ii];
        bq[ii] = gf;  // the running gF above slot j (unread for j = d - 1)
        gf = (j == d - 1) ? gF : gF + gf * tt_of(ts[row(j)]);
      }
    }
    float aa = f0;
#pragma unroll
    for (int ii = 0; ii < kSPRegDeg; ++ii) {
      const int j = cc * kSPRegDeg + ii;
      if (j < d) {
        const int si = row(j);
        const float raw = ts[si];
        const float share = (j == d - 1) ? 0.0f : bq[ii] * aa;
        aa = (j == 0) ? tt_of(raw) : aa * tt_of(raw);
        const float g_tt = share + gc[si];
        const float g_x = g_tt * (-0.5f) * (1.0f - raw * raw);
        gc[si] = ((inside >> j) & 1ull) ? g_x : 0.0f;
      }
    }
  }
  return sw;
}

// Shared memory: `BwdLayout`.  tab: the training table (the decode table,
// then edge_cn[E] and edge_shift[E] in VN order for the per-edge sums).
// kSP: the CN phase is SP's (sp_check_bwd), for checks of at most kChunks
// chunks of kSPRegDeg slots (1: d <= kSPRegDeg, as on wman; kSPChunks).
// B5 and B5-SP for checks past one chunk take the training pair's launch
// bound (56 registers; the wide instance spills, and ran faster here than
// at 80 registers), B5-SP for checks of one chunk SP's (80 registers), at
// which it does not spill.
template <bool kSP, int kChunks>
__global__ void __launch_bounds__((kSP && kChunks == 1) ? kSPThreads : kTwoBlockThreads,
                                  (kSP && kChunks == 1) ? 1 : 2)
train_bwd_kernel(const float* __restrict__ llr, const float* __restrict__ w_cn,
                 const float* __restrict__ w_ucn,
                 const float* __restrict__ w_vn, const int* __restrict__ tab,
                 const float* __restrict__ hist, const float* __restrict__ cres,
                 const float* __restrict__ apps_pre,
                 const float* __restrict__ g_apps, float* __restrict__ part_cn,
                 float* __restrict__ part_ucn, float* __restrict__ part_vn,
                 Cfg c, const float* __restrict__ last_pre,
                 const float* __restrict__ g_last) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdLayout L(c, kSP);
  const int z = c.z, G = c.G, B = c.B, T = c.T;
  const int Nz = c.N * z, Mz = c.M * z, Ez = c.E * z;
  const int EzG = Ez * G, MzG = Mz * G, zG = z * G;
  const int R = c.R(kSP);
  const int cn_sum = c.cn_sum(), vn_sum = c.vn_sum();
  const bool cnw = c.cn_mode > 0, vnw = c.vn_mode > 0;
  const bool per_edge = c.cn_mode == 1 || c.cn_mode == 4;
  const Graph gr = stage_table(tab, reinterpret_cast<int*>(smem_raw), c.N,
                               c.M, c.E, z, G);
  const int* edge_cn = tab + 4 * c.E + c.N + c.M + 2;  // VN order, device memory
  const int* edge_shift = edge_cn + c.E;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + L.bar);
  float* wc = reinterpret_cast<float*>(smem_raw + L.w);
  float* wu = wc + c.dim_cn;
  float* wv = wu + c.dim_cn;
  float* hs = reinterpret_cast<float*>(smem_raw + L.stage);  // the staged run:
  const float* cs = hs + EzG;                                 // hist, then cres
  float* gc = reinterpret_cast<float*>(smem_raw + L.gc);
  int2* ltab = reinterpret_cast<int2*>(smem_raw + L.lifted);  // SP
  if (kSP) stage_lifted(tab, ltab, c.E, z, gr.lg);
  float* gw = reinterpret_cast<float*>(smem_raw + L.gw);
  float* gv = reinterpret_cast<float*>(smem_raw + L.gv);
  float* isc = reinterpret_cast<float*>(smem_raw + L.item);  // per item: CN
  float* isu = isc + MzG;                                     // and UCN
  float* red_c = reinterpret_cast<float*>(smem_raw + L.red);
  float* red_u = red_c + c.E;
  float* red_v = reinterpret_cast<float*>(smem_raw + L.red_v);
  float* wsum = reinterpret_cast<float*>(smem_raw + L.wsum);  // [32]
  uint8_t* ucn_s = smem_raw + L.ucn_s;
  const size_t Tz = (size_t)c.target * z;
  const float mclip = c.ms.msg_clip();
  const float kOutside = __int_as_float(0x7f800000);  // +inf: outside the clip

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int gt = tid & (G - 1);
  const int b = blockIdx.x * G + gt;
  const bool real = b < B;
  const Rows rows0(tid >> gr.lg, nthr >> gr.lg, z);  // this thread's items
  // this block's residual runs of iteration t
  auto hist_t = [&](int t) { return hist + ((size_t)blockIdx.x * T + t) * EzG; };
  auto cres_t = [&](int t) { return cres + ((size_t)blockIdx.x * T + t) * R * MzG; };
  auto stage_it = [&](int t) {  // by one thread: iteration t into the buffer
    stage_tiles(hs, hist_t(t), 4u * EzG, cres_t(t), 4u * R * MzG, bar);
  };

  // cotangent of iteration tt's clipped APP on lifted bit `row` (0 outside
  // the emission window, the target columns, or the clip)
  auto fold = [&](int tt, int row) -> float {
    if (tt < c.t0 || row >= c.target * z) return 0.0f;
    const size_t at = ((size_t)(tt - c.t0) * Tz + row) * B + b;
    const float ap = __ldg(apps_pre + at);
    return (ap >= -c.ms.clip_llr && ap <= c.ms.clip_llr) ? __ldg(g_apps + at)
                                                         : 0.0f;
  };

  stage_weights(w_cn, wc, T - 1, c.dim_cn);
  if (c.ucn) stage_weights(w_ucn, wu, T - 1, c.dim_cn);
  stage_weights(w_vn, wv, T - 1, c.dim_vn);
  if (tid == 0) {
    init_stage_bar(bar);
    stage_it(T - 1);
  }
  __syncthreads();  // the tables, the weights, the mbarrier
  for (Rows it = rows0; it.row < Nz; it.next()) {
    float f = real ? fold(T - 1, it.row) : 0.0f;
    if (real && g_last != nullptr && (size_t)it.row >= Tz) {  // the last APP's other rows
      const size_t at = (size_t)(it.row - Tz) * B + b;
      const float ap = __ldg(last_pre + at);
      f = (ap >= -c.ms.clip_llr && ap <= c.ms.clip_llr) ? __ldg(g_last + at) : 0.0f;
    }
    for (int e = gr.vn_ptr[it.q], r = e * z + it.r; e < gr.vn_ptr[it.q + 1];
         ++e, r += z)
      gc[gr.at(r, gt)] = f;
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // ---- CN phase: per lifted check -----------------------------------
    wait_tiles(bar, (T - 1 - t) & 1);  // iteration t's run
    for (Rows it = rows0; it.row < Mz; it.next()) {
      const int g = gt;
      const int row = it.row, i = it.q, h = it.r;
      const int k = gr.at(row, g);
      const int k0 = gr.cn_ptr[i], k1 = gr.cn_ptr[i + 1];
      if (!real) {  // a ragged block's missing words contribute nothing
        for (int q = k0; q < k1; ++q) {
          const int4 sd = gr.slot[q];
          const int si = gr.at(sd.x + gr.sub(sd, h), g);
          gc[si] = 0.0f;
          if (cn_sum == kPerSlot) gw[si] = 0.0f;
        }
        if (cn_sum == kPerSlot && c.ucn) ucn_s[k] = 0;
        if (cn_sum == kPerItem) isc[k] = isu[k] = 0.0f;
        continue;
      }
      if (kSP) {
        const float u = c.ucn ? cs[k] : 0.0f;  // R = 1: the UCN mask
        if (cn_sum == kPerSlot && c.ucn) ucn_s[k] = u > 0.5f;
        const int2* lt = ltab + k0 * z + h;
        auto row = [&](int j) { return lt[j * z].x + g; };
        const float sw = sp_check_bwd<kChunks>(c, row, hs, gc, gw, cn_sum == kPerSlot,
                                               wc, wu, i, k0, k1 - k0, u);
        if (cn_sum == kPerItem) {
          const bool on_ucn = c.ucn && u > 0.5f;
          isc[k] = on_ucn ? 0.0f : sw;
          isu[k] = on_ucn ? sw : 0.0f;
        }
        continue;
      }
      const float m1 = cs[k];
      const float m2 = cs[gr.at(row + Mz, g)];
      const float neg_tot = cs[gr.at(row + 2 * Mz, g)];
      const float u = c.ucn ? cs[gr.at(row + 3 * Mz, g)] : 0.0f;
      if (cn_sum == kPerSlot && c.ucn) ucn_s[k] = u > 0.5f;
      const float w_chk =
          (cnw && !per_edge) ? cn_w(wc, wu, cn_col(c.cn_mode, i, 0), c.ucn, u) : 1.0f;
      // pass 1: the message (kept in the staged slot, +inf outside the
      // clip), the weighting chain, tie counts and sums
      float c1 = 0.0f, c2 = 0.0f, g_above = 0.0f, g_min = 0.0f, sw = 0.0f;
      for (int q = k0; q < k1; ++q) {
        const int4 sd = gr.slot[q];
        const int si = gr.at(sd.x + gr.sub(sd, h), g);
        const float pre = hs[si];
        const float x = c.ms.v2c(pre);
        hs[si] = (fabsf(pre) <= mclip) ? x : kOutside;
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
          w_eff = per_edge ? cn_w(wc, wu, q, c.ucn, u) : w_chk;
          r = c.offset_mode ? magp - w_eff : magp * w_eff;
        }
        // ReLU (gradient 0 at 0) and the inclusive mask of the STE/clip on
        // its output collapse to 0 < r <= clip
        const float g_r = (r > 0.0f && r <= mclip) ? gc[si] * so : 0.0f;
        const float g_mag = (cnw && !c.offset_mode) ? g_r * w_eff : g_r;
        if (cnw) {
          const float gwv = c.offset_mode ? -g_r : g_r * magp;
          if (cn_sum == kPerSlot)
            gw[si] = gwv;
          else
            sw += gwv;
        }
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
      // the check's shares: of the larger slots' sum to a slot at m1, of the
      // min slot's to a slot at m2
      const float to_m1 = multi ? g_above / c1 : g_above;
      const float to_m2 = multi ? 0.0f : g_min / c2;
      const float ties = fmaxf(c1 - 1.0f, 1.0f);
      // pass 2: the tie-splitting extrinsic-min backward, |x|, the nudge
      // (gradient 1) and the inclusive mask of the V->C quantizer/clip
      for (int q = k0; q < k1; ++q) {
        const int4 sd = gr.slot[q];
        const int si = gr.at(sd.x + gr.sub(sd, h), g);
        const float x = hs[si];
        if (x == kOutside) {
          gc[si] = 0.0f;
          continue;
        }
        const float a = (x == 0.0f) ? kPadMag : fabsf(x);
        float ga = 0.0f;
        if (a == m1)
          ga = multi ? to_m1 + (g_min - gc[si]) / ties : to_m1;
        else if (a == m2)
          ga = to_m2;
        gc[si] = (x >= 0.0f) ? ga : -ga;
      }
      const bool on_ucn = c.ucn && u > 0.5f;
      if (cn_sum == kPerItem) {
        isc[k] = on_ucn ? 0.0f : sw;
        isu[k] = on_ucn ? sw : 0.0f;
      }
    }
    __syncthreads();
    // the buffer is free: stage iteration t - 1 into it
    if (tid == 0 && t > 0) stage_it(t - 1);

    // ---- CN-weight sums; VN phase: per lifted bit ---------------------
    const size_t pb = (size_t)blockIdx.x * T + t;
    if (cn_sum == kPerSlot) {
      for (int e = warp; e < c.E; e += nwarps) {
        const int i = __ldg(edge_cn + e), sh = __ldg(edge_shift + e);
        float sc = 0.0f, su = 0.0f;
        for (int idx = lane; idx < zG; idx += 32) {
          const float v = gw[e * zG + idx];
          const int s = idx >> gr.lg, g = idx & (G - 1);
          const int hh = (s >= sh) ? s - sh : s - sh + z;
          if (c.ucn && ucn_s[gr.at(i * z + hh, g)])
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
    } else if (cn_sum == kPerItem) {  // one check per warp
      for (int i = warp; i < c.M; i += nwarps) {
        float sc = 0.0f, su = 0.0f;
        for (int idx = lane; idx < zG; idx += 32) {
          sc += isc[i * zG + idx];
          su += isu[i * zG + idx];
        }
        sc = warp_sum(sc);
        su = warp_sum(su);
        if (lane == 0 && c.cn_mode == 3) {  // the check's sums, over its first
          isc[i * zG] = sc;                 // item (the warp has read them)
          isu[i * zG] = su;
        } else if (lane == 0) {
          part_cn[pb * c.dim_cn + i] = sc;
          if (c.ucn) part_ucn[pb * c.dim_cn + i] = su;
        }
      }
    }
    float acc_v = 0.0f;  // register sum (scalar VN sharing)
    for (Rows it = rows0; it.row < Nz; it.next()) {
      const int row = it.row, j = it.q, s = it.r;
      const int k = gr.at(row, gt);
      const int e0 = gr.vn_ptr[j], e1 = gr.vn_ptr[j + 1];
      if (!real) {
        for (int e = e0, r = e0 * z + s; e < e1; ++e, r += z) gc[gr.at(r, gt)] = 0.0f;
        if (vn_sum == kPerSlot) gv[k] = 0.0f;
        continue;
      }
      const float g_tot = gr.bit_sum(gc, j, s, gt);
      if (vnw) {
        const float x = __ldg(llr + (size_t)row * B + b);
        const float lw = x * wv[c.vn_col(j)];
        const bool inside = !c.ms.qms() || fabsf(lw) <= c.ms.qclip;
        const float v = (inside ? g_tot : 0.0f) * x;
        if (vn_sum == kPerSlot)
          gv[k] = v;
        else
          acc_v += v;
      }
      if (t > 0) {
        const float f = fold(t - 1, row);
        for (int e = e0, r = e0 * z + s; e < e1; ++e, r += z) {
          const int si = gr.at(r, gt);
          gc[si] = (g_tot - gc[si]) + f;
        }
      }
    }
    if (vn_sum == kInRegs) {
      acc_v = warp_sum(acc_v);
      if (lane == 0) wsum[warp] = acc_v;
    }
    __syncthreads();

    // ---- weight-gradient partials of this block and iteration ---------
    if (cn_sum == kPerSlot) {
      for (int d = tid; d < c.dim_cn; d += nthr) {
        float vc, vu;
        if (per_edge) {
          vc = red_c[gr.slot[d].w];
          vu = red_u[gr.slot[d].w];
        } else {
          const bool per_check = c.cn_mode == 2 || c.cn_mode == 5;
          const int q0 = per_check ? gr.cn_ptr[d] : 0;
          const int q1 = per_check ? gr.cn_ptr[d + 1] : c.E;
          vc = red_c[gr.slot[q0].w];
          vu = red_u[gr.slot[q0].w];
          for (int q = q0 + 1; q < q1; ++q) {
            vc += red_c[gr.slot[q].w];
            vu += red_u[gr.slot[q].w];
          }
        }
        part_cn[pb * c.dim_cn + d] = vc;
        if (c.ucn) part_ucn[pb * c.dim_cn + d] = vu;
      }
    } else if (cn_sum == kPerItem && c.cn_mode == 3 && tid == 0) {
      float vc = isc[0], vu = isu[0];  // scalar: the checks' sums, in order
      for (int i = 1; i < c.M; ++i) {
        vc += isc[i * zG];
        vu += isu[i * zG];
      }
      part_cn[pb * c.dim_cn] = vc;
      if (c.ucn) part_ucn[pb * c.dim_cn] = vu;
    }
    if (vn_sum == kPerSlot) {
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
    } else if (vn_sum == kInRegs && tid == 0) {
      float v = wsum[0];  // the warps' sums, in order
      for (int w = 1; w < nwarps; ++w) v += wsum[w];
      part_vn[pb * c.dim_vn] = v;
    }
    if (t > 0) {  // the next iteration's weights
      stage_weights(w_cn, wc, t - 1, c.dim_cn);
      if (c.ucn) stage_weights(w_ucn, wu, t - 1, c.dim_cn);
      stage_weights(w_vn, wv, t - 1, c.dim_vn);
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
             int t0, int Dc, int dec_type, float qstep, float qinv,
             float qclip, float clip_llr, int cn_mode, int ucn, int vn_mode,
             int offset_mode, int dim_cn, int dim_vn) {
  Cfg c;
  c.N = N; c.M = M; c.z = z; c.E = E; c.T = T; c.B = B; c.G = G;
  c.target = target; c.t0 = t0; c.Dc = Dc;
  c.ms = Msg{dec_type, qinv, qstep, qclip, clip_llr};
  c.cn_mode = cn_mode; c.ucn = ucn; c.vn_mode = vn_mode;
  c.offset_mode = offset_mode; c.dim_cn = dim_cn; c.dim_vn = dim_vn;
  return c;
}

}  // namespace

#define TRAIN_CFG_ARGS                                                       \
  int N, int M, int z, int E, int T, int B, int G, int W, int threads,       \
      int smem, int target, int t0, int Dc, int dec_type, float qstep,       \
      float qinv, float qclip, float clip_llr, int cn_mode, int ucn,         \
      int vn_mode, int offset_mode, int dim_cn, int dim_vn
#define TRAIN_CFG                                                            \
  make_cfg(N, M, z, E, T, B, G, target, t0, Dc, dec_type, qstep, qinv,       \
           qclip, clip_llr, cn_mode, ucn, vn_mode, offset_mode, dim_cn,      \
           dim_vn)

// B4: fused_nms_kernel<kTrain, SP?>.  Writes apps [T-t0][target*z][B]
// (pre-clip) and, when hist is not null, hist [tiles][T][E*z][W] and cres
// [tiles][T][R*M*z][W] (null for SP without UCN), tiles = ceil(B / W), W
// the backward's G; when `last` is not null (the instance with kExtra 1), the
// last iteration's pre-clip APP of the rows past the target, last
// [(N-target)*z][B].  `smem` is one block's dynamic shared memory
// (ops/fused_decoder.py::_smem_bytes); qinv = 1/qstep exactly.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_nms_train_fwd_launch(
    const void* llr, const void* w_cn, const void* w_ucn, const void* w_vn,
    const void* tab, void* apps, void* hist, void* cres, void* last,
    TRAIN_CFG_ARGS, void* stream) {
  const Msg ms{dec_type, qinv, qstep, qclip, clip_llr};
#define TRAIN_FWD_LAUNCH(SP, CHUNKS, EXTRA)                                   \
  launch<kTrain, SP, false, CHUNKS, EXTRA>(llr, w_cn, w_ucn, w_vn, tab, apps, \
                            nullptr,                                          \
                            nullptr, nullptr, nullptr, hist, cres, N, M, z,   \
                            E, T, B, G, W, threads, smem, target, t0, ms,     \
                            cn_mode, ucn, vn_mode, offset_mode, dim_cn,       \
                            dim_vn, (cudaStream_t)stream, nullptr, nullptr,   \
                            last)
  const bool x = last != nullptr;
  if (dec_type != kSPDec)
    return x ? TRAIN_FWD_LAUNCH(false, kSPChunks, 1) : TRAIN_FWD_LAUNCH(false, kSPChunks, 0);
  if (Dc <= kSPRegDeg)
    return x ? TRAIN_FWD_LAUNCH(true, 1, 1) : TRAIN_FWD_LAUNCH(true, 1, 0);
  return x ? TRAIN_FWD_LAUNCH(true, kSPChunks, 1) : TRAIN_FWD_LAUNCH(true, kSPChunks, 0);
#undef TRAIN_FWD_LAUNCH
}

// B5 (B5-SP for dec_type SP), G = W words per block.  Reads the forward's
// residuals and the APP cotangent g_apps (same layout as apps) and, when
// g_last is not null, the cotangent of the last APP's rows past the target
// (same layout as last_pre, B4's `last`), writes the partials part_*
// [blocks][T][dim] (scratch) and the weight gradients g_* [T][dim] (null
// for a kind without weights).  Returns -2 when `smem` is not the layout's
// size, else cudaGetLastError() after the launches (0 = launched).
extern "C" int fused_nms_train_bwd_launch(
    const void* llr, const void* w_cn, const void* w_ucn, const void* w_vn,
    const void* tab, const void* hist, const void* cres,
    const void* apps_pre, const void* g_apps, const void* last_pre,
    const void* g_last, void* part_cn, void* part_ucn, void* part_vn,
    void* g_cn, void* g_ucn, void* g_vn, TRAIN_CFG_ARGS, void* stream) {
  (void)W;
  cudaStream_t s = (cudaStream_t)stream;
  const bool sp = dec_type == kSPDec;
  const Cfg cfg = TRAIN_CFG;
  if (BwdLayout(cfg, sp).end != smem) return -2;
  auto* kernel = !sp                  ? train_bwd_kernel<false, 1>
                 : Dc <= kSPRegDeg ? train_bwd_kernel<true, 1>
                                   : train_bwd_kernel<true, kSPChunks>;
  cudaError_t st = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return (int)st;
  const int blocks = (B + G - 1) / G;
  kernel<<<blocks, threads, smem, s>>>(
      (const float*)llr, (const float*)w_cn, (const float*)w_ucn,
      (const float*)w_vn, (const int*)tab, (const float*)hist,
      (const float*)cres, (const float*)apps_pre, (const float*)g_apps,
      (float*)part_cn, (float*)part_ucn, (float*)part_vn, cfg,
      (const float*)last_pre, (const float*)g_last);
  int rc = (int)cudaGetLastError();
  if (rc == 0) rc = reduce(part_cn, g_cn, blocks, T * dim_cn, s);
  if (rc == 0) rc = reduce(part_ucn, g_ucn, blocks, T * dim_cn, s);
  if (rc == 0) rc = reduce(part_vn, g_vn, blocks, T * dim_vn, s);
  return rc;
}
