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
//     (G = 8 on wman, where one block of 16 was 7.7% slower); B4-SP takes
//     SP's bound (below) where every check fits one chunk of kSPRegDeg
//     slots (there it does not spill; at 56 registers it spilled 32 bytes
//     and ran as fast), else the pair's (it spills 16 bytes, and ran 9%
//     faster on 802.11n than at 80 registers); the SP decode instances
//     take blocks of up to 768 threads at 80 registers (kSPThreads), and
//     the host picks, for a fixed T and the syndrome stop, the shape that
//     keeps the most warps resident with the fullest check phase (two
//     blocks of eight words and 384 threads on wman, three of four and 256
//     on 802.11n, one of 768 on the 5G codes of z = 64 and 72); MS and
//     MS_RAW keep one block of up to 1024 threads.
// SP (B1-SP, and B4-SP in kTrain) pays a tanhf and an atanhf per slot, so
// its check update keeps the rest of a slot's work small: every SP instance
// reads both row offsets of a slot from the lifted slot table (below), and
// two passes over the slots replace three: the reverse pass
// derives each V->C message and its tanh and accumulates the suffix
// products, a chunk of kSPRegDeg slots at a time (an unrolled loop into
// registers, no local array), keeping the running product at the top of
// each chunk; the forward pass accumulates the prefix products and writes
// each C->V message, a chunk at a time: chunk 0's suffix products are the
// reverse pass's, a later chunk's are formed again from its top's running
// product and its own slots' tanh values (one more load and product per
// slot past the first chunk), in the same order.  Every product is the one
// the per-slot arrays gave, so B1-SP's outputs did not move (a CPU test,
// tests/test_torch_kernel_layout.py, emulates both orders).  B4-SP takes an
// instance for checks of one chunk (kChunks = 1, as on wman: no chunk tops)
// where the code's checks allow.
// Under QMS the decode instances (kCode: B1, B2, B3) keep their state in
// integer codes: every stored value is a whole number of u, the largest
// power of two dividing the grid's step and clip (0.5 for q_bit 5), so a
// word needs 3.2 KB instead of 11.3 on wman and three blocks of up to 384
// threads share an SM (kCodeThreads, kCodeBlocks: 56 registers; four of
// G = 8 lanes on wman for the early stop, fused_nms_kernel_word_stop
// below), so one block's barrier leaves the SM others to issue:
//   - a C->V message is one byte, its code as 7-bit two's complement, with
//     bit 7 flagging -0 (a negative message whose weighted magnitude
//     rounds to 0); a bit total is an int16, twice its code plus the bit's
//     hard decision (so phase B reads the UCN and syndrome parity with the
//     total it already loads); a V->C message, kept in its C->V slot
//     between phase B's passes, is a sign-magnitude byte whose magnitude 0
//     stands for +kEps (0 is always nudged to +kEps);
//   - phase A sums a bit's codes as integers (one sign extension a slot)
//     and converts the sum once; a zero sum is -0, as the float sum would
//     be, when every term is -0, which only matters, and is only checked,
//     where an APP is written (a -0 APP needs a -0 channel value);
//   - a lifted slot table (`stage_lifted`, 8 bytes per lifted edge) gives
//     each slot's two row offsets in one load, with no modular arithmetic;
//   - pass 1 derives each V->C code in integers (quantize_code: a clamp,
//     and for q_bit 6 a half-to-even shift, in its own copy of the loop)
//     with min1/min2 over the magnitudes and the parity of the negatives;
//     the CN/UCN weight, ReLU and quantizer run in float once per check
//     and extrinsic magnitude, or, for scalar or no CN weights, once per
//     block and iteration into a table of output bytes for every
//     magnitude code and UCN mask (`code_out_bytes`); each gives four
//     bytes (either magnitude, either sign), and pass 2 picks a slot's by
//     its min1 flag and sign (one byte permute); per-edge weights per slot.
// The code state gives the float loop's outputs bit for bit (the sign of
// every APP included): the integer steps are exact, and a CPU test
// (tests/test_torch_kernel_layout.py) holds each to the float loop.
// The stops of this loop end a block's loop, never a thread's: the float
// state's early stop decides with __syncthreads_or after the statistics of
// an iteration, deploy after phase B, from shared flags that every thread
// reads alike.  Both stop per block of G words, so they take fewer words
// under more blocks than the fixed T (kDeployBlocks; the float early stop
// one block of the most words).  A block of G words stops as a whole (the
// JAX tile stops as a whole too, at another size), so the float early
// stop's rows after a block's stop and its APP depend on G; the
// genie-failure mask and every deploy output do not.  The code state's
// early stop is a kernel of its own (fused_nms_kernel_word_stop, below):
// each word stops alone, its rows and APP those of its own stop, whatever
// G.  (A persistent grid of blocks that kept the block stop, taking tiles
// of G words from a counter, ran 5% slower at 5.5 dB than one block per G
// words: persistence alone does not pay; the stop per word does the work.)
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
// The instances with kExtra > 0 take what the scan decoder gives beyond the
// zero word, each behind a pointer that may be null, so the instances
// without it stay as they were.  kExtra = 1: the decode modes count a bit
// wrong where its hard decision differs from the codeword bit `lab` (uint8
// [target*z][B], read with the bit's LLR at each count); kTrain writes,
// with `last_out`, the last iteration's pre-clip APP of the rows past the
// target ([(N-target)*z][B]), so that the caller has that iteration's whole
// APP.  kExtra = 2 (the fixed T): also each iteration's syndrome flag per
// word, `synd_out` [T][B] (H*x == 0: phase B's parity of the previous
// decisions, which UCN and the syndrome stop already compute, gathered per
// word in shared memory).  The two are apart because the flags' code
// slowed the labelled fixed T by 4% on wman (PERF.md).
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
// The launch bound of the code-domain decode instances (QMS B1, B2, B3):
// kCodeBlocks blocks of at most kCodeThreads threads per SM (56
// registers), kEarlyStopBlocks for the genie early stop (40 registers;
// fused_nms_kernel_word_stop, G lanes a block)
// (ops/fused_decoder.py::_CODE_THREADS, _CODE_BLOCKS, _EARLY_STOP_BLOCKS).
constexpr int kCodeThreads = 384;
constexpr int kCodeBlocks = 3;
constexpr int kEarlyStopBlocks = 4;
// The syndrome stop's own bound (code state): like the float state's early
// stop, a block runs until its slowest word stops, so it takes fewer words under more
// blocks: kDeployBlocks blocks of at most kDeployThreads threads (G = 4 on
// wman, 56 registers; G = 8 under four blocks of 384 was 6.8% slower at
// 4.0 dB, 1.7% at 5.5 dB) (ops/fused_decoder.py::_DEPLOY_THREADS,
// _DEPLOY_BLOCKS).
constexpr int kDeployThreads = 192;
constexpr int kDeployBlocks = 6;
// The SP decode instances (float state): blocks of at most kSPThreads
// threads, so at most 80 registers (at 1024 threads, 64 registers spilled
// 76 bytes) and 24 resident warps per SM
// (ops/fused_decoder.py::_SP_THREADS, sp_launch_shape).  The early stop
// takes one block of the most words (its rows after a block's stop depend
// on G: 16 on wman).
constexpr int kSPThreads = 768;
// SP forms a check's suffix products a chunk of kSPRegDeg slots at a time,
// in registers (an unrolled loop), and keeps the running product at the top
// of each of its kSPChunks chunks.
constexpr int kSPRegDeg = 16;
constexpr int kSPChunks = kMaxDegSP / kSPRegDeg;
static_assert(kMaxDegSP % kSPRegDeg == 0, "whole chunks of SP slots");

__device__ __forceinline__ float clip(float x, float lim) {
  return fminf(fmaxf(x, -lim), lim);
}

// The message arithmetic of one decoding type: the QMS grid (step, its
// exact reciprocal, clip) or the LLR clip; with the code-domain state
// (kCode, QMS only) also the code unit u (the largest power of two that
// divides both step and clip), 1/u, the clip in units of u, and log2(step/u).
struct Msg {
  int dec_type;
  float qinv, qstep, qclip, clip_llr;
  float u, uinv;
  int clipc, qshift;

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

  // Code domain: a grid value v is the integer v / u, exactly.
  __device__ __forceinline__ int to_code(float v) const {
    return __float2int_rn(v * uinv);
  }
  // `quantize` of the value pre * u, in units of u: round half to even at
  // the step (2^qshift units; kShift: qshift > 0, else a clip alone), then
  // clip.  Exact in integers (a CPU test, tests/test_torch_kernel_layout.py,
  // holds it to the float quantizer).
  template <bool kShift>
  __device__ __forceinline__ int quantize_code(int pre) const {
    int x = pre;
    if (kShift)
      x = ((pre + (1 << (qshift - 1)) - 1 + ((pre >> qshift) & 1)) >> qshift)
          << qshift;
    return min(max(x, -clipc), clipc);
  }
};

// The code-domain C->V byte: the value's code k (|k| <= 63) as 7-bit two's
// complement in bits 0-6, and bit 7 set only for -0 (k = 0 with the sign
// bit; a C->V message is -0 when a negative message's weighted magnitude
// rounds to 0).  One sign extension of bits 0-6 gives k, and -0 reads 0.
constexpr uint8_t kNegZero = 0x80;
__device__ __forceinline__ int c2v_code(uint8_t b) {
  return ((int)((unsigned)b << 25)) >> 25;
}
// (The V->C byte kept in a C->V slot between the two passes of phase B is
// sign-magnitude: bit 7 the sign, bits 0-6 |k|; magnitude 0 is kEps, since
// a V->C message is never 0: 0 is nudged to +kEps.)
constexpr int kPadC = 1 << 30;  // the extrinsic min's sentinel, in codes
// Entries of the per-iteration table of output bytes (code state, scalar or
// no CN weights): [UCN mask 0/1][extrinsic magnitude code 0..clipc, then
// the sentinel], clipc <= 63.
constexpr int kLutRow = 66;
constexpr int kLutInts = 2 * kLutRow;

// The C->V bytes of a check slot whose extrinsic magnitude is the code mc
// (kPadC: the sentinel), under the CN weight w (the float loop's chain:
// the eps fix, weight, ReLU, quantizer), positive in bits 0-7 and negative
// in bits 8-15; 0 when the magnitude fixes to 0 (the message's sign is then
// 0 and the message +0).
__device__ __forceinline__ int code_out_bytes(const Msg& ms, int mc, float w,
                                              int cn_mode, int offset_mode) {
  float mag = mc >= kPadC ? kPadMag : (mc == 0 ? kEps : __int2float_rn(mc) * ms.u);
  mag = (mag <= kEps) ? mag - kEps : mag;
  float wmag = mag;
  if (cn_mode > 0) wmag = offset_mode ? mag - w : mag * w;
  wmag = (wmag > 0.0f) ? wmag : 0.0f;
  wmag = ms.out(wmag);
  if (mag == 0.0f) return 0;
  const int wcode = ms.to_code(wmag);
  return wcode | ((wcode ? ((-wcode) & 0x7f) : kNegZero) << 8);
}

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
  int z, lg, zG;  // zG = z << lg

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

  // The code-domain twin of `bit_sum`: the sum of the C->V codes of lifted
  // bit (j, s), word g (exact; the float sum is it times u, up to the sign
  // of a zero sum, which `all_neg_zero` settles).
  __device__ __forceinline__ int code_sum(const uint8_t* a, int j, int s,
                                          int g) const {
    int S = 0;
    const int e0 = vn_ptr[j], e1 = vn_ptr[j + 1];
    const uint8_t* p = a + at(e0 * z + s, g);
    for (int e = e0; e < e1; ++e, p += zG) S += c2v_code(*p);
    return S;
  }

  // Parity of the hard decisions (bit 0 of the packed totals `tot` of
  // word g) on the bits of lifted check (i, h), through the lifted slot
  // table `lt` (`stage_lifted`).
  __device__ __forceinline__ int code_parity(const int2* lt, const short* tot,
                                             int i, int h) const {
    int par = 0;
    const int2* o = lt + cn_ptr[i] * z + h;
    for (int q = cn_ptr[i]; q < cn_ptr[i + 1]; ++q, o += z) par ^= tot[o->y];
    return par & 1;
  }

  // Whether every C->V message of lifted bit (j, s), word g, is -0: then,
  // and only then, their slot-order float sum is -0.
  __device__ bool all_neg_zero(const uint8_t* a, int j, int s, int g) const {
    bool all = true;
    const int e0 = vn_ptr[j], e1 = vn_ptr[j + 1];
    int r = e0 * z + s;
    for (int e = e0; e < e1; ++e, r += z) all = all && a[at(r, g)] == kNegZero;
    return all;
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
  gr.zG = z << gr.lg;
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

// The code state's lifted slot table: for each check-order slot q and
// lifted check h, at q*z + h, the row offsets (row << lg, word 0) of the
// slot's C->V message and of its bit's total, {(e*z + sl) << lg, (vn*z +
// sl) << lg} with sl = (h + shift) mod z, built from the graph table in
// device memory (the caller synchronises before use).
__device__ void stage_lifted(const int* __restrict__ tab, int2* dst, int E,
                             int z, int lg) {
  const int4* slot = reinterpret_cast<const int4*>(tab);
  for (int k = threadIdx.x; k < E * z; k += blockDim.x) {
    const int q = k / z, h = k - q * z;
    const int4 sd = __ldg(slot + q);
    const int sl = h + sd.z >= z ? h + sd.z - z : h + sd.z;
    dst[k] = make_int2((sd.x + sl) << lg, (sd.y + sl) << lg);
  }
}

// Bytes of the decode kernel's shared memory (the layouts below;
// ops/fused_decoder.py::_smem_bytes computes the same).
// `lifted`: the float state carries the lifted slot table (SP decode).
// `track`: the fixed T's syndrome flags (two more int [G], and the parity
// bits in the float state).
__host__ __device__ __forceinline__ int decode_smem_bytes(int N, int M, int z,
                                                          int E, int G,
                                                          int ucn, bool deploy,
                                                          bool code, bool lifted,
                                                          bool track = false) {
  const int head = table_bytes(N, M, E) + 4 * ((2 * E + N + 3) & ~3);
  const int cnt = (deploy || track ? 4 : 2) * G;
  const int bits = (ucn || deploy || track) ? N * z * G : 0;
  if (code)  // no parity bits: each is bit 0 of its bit's packed total
    return head + 4 * ((cnt + kLutInts + 3) & ~3) + 8 * E * z + 2 * N * z * G +
           E * z * G;
  return head + (lifted ? 8 * E * z : 0) + 4 * (E * z + N * z) * G + 4 * cnt + bits;
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
// 16 bytes; cn, ucn and vn of one iteration), then the state of G words:
//   float state: SP decode only: the lifted slot table int2 [E*z] | C->V
//     float [E*z][G] | bit totals float [N*z][G] | error
//     counts int [2][G] | deploy only: frozen int [G], last unsatisfied step
//     int [G] | syndrome flags int [2][G] (fixed T with synd_out) | parity bits
//     uint8 [N*z][G] (with UCN, in deploy mode or with synd_out);
//   code state (kCode): error counts int [2][G] | deploy: frozen, last
//     unsatisfied step int [G] each | syndrome flags int [2][G] (fixed T
//     with synd_out) | the output-byte table int
//     [kLutInts], padded to 16 bytes | the lifted slot table int2 [E*z] |
//     bit totals int16 [N*z][G] (2 * code + the bit's hard decision) |
//     C->V uint8 [E*z][G] (C->V bytes, V->C bytes between the passes).
// Outputs: stats modes app [N*z][B] (clipped), err uint8 [T][B], nerr int
// [T][B]; deploy app, err uint8 [B], nerr int [B], iters int [B], fail uint8
// [B]; with kExtra 2, synd_out uint8 [T][B] (fixed T), and kTrain's last_out
// float [(N-target)*z][B]; kTrain app [T-t0][target*z][B] (pre-clip) and, with hist_out, hist
// [tiles][T][E*z][W] and cres [tiles][T][R*M*z][W] (min-sum: R = 4 with
// UCN, else 3; SP: R = 1 with UCN, else no cres), tiles = ceil(B / W).
// Pass 1 of phase B in the code state for lifted check (i, h) of word g
// (its check-order slots [k0, k1); `lt` the lifted slot table at k0*z + h,
// c2v8 and tot16 offset to word g): each V->C message in codes, derived
// once (at the first iteration every C->V message is 0) and kept as a
// sign-magnitude byte in its own C->V slot; min1/min2 of the magnitudes
// (code 0, kEps, the smallest), the XOR of the messages (bit 31: the
// parity of the negative ones) and of the packed totals (bit 0: the parity
// of the check's hard decisions).
struct CodePass1 {
  int m1, m2, nneg, par;
};

template <bool kShift, class Slot>
__device__ __forceinline__ CodePass1 code_pass1(const Msg& ms, const Slot* lt,
                                                uint8_t* c2v8, const short* tot16,
                                                int k0, int k1, int z, bool first) {
  CodePass1 r{kPadC, kPadC, 0, 0};
  for (int q = k0; q < k1; ++q, lt += z) {
    const Slot o = *lt;
    uint8_t* c = c2v8 + o.x;
    const int tv = tot16[o.y];
    const int x = ms.quantize_code<kShift>((tv >> 1) - (first ? 0 : c2v_code(*c)));
    const int a = abs(x);
    *c = (uint8_t)(a | ((x >> 24) & 0x80));
    r.m2 = min(r.m2, max(r.m1, a));
    r.m1 = min(r.m1, a);
    r.nneg ^= x;
    r.par ^= tv;
  }
  return r;
}

template <int kMode, bool kSP, bool kCode, int kChunks = kSPChunks>
struct LaunchBound {
  // the state carries the lifted slot table: the code state and every SP
  // instance, B4-SP's included (decode_smem_bytes' `lifted` for the float
  // state)
  static constexpr bool lifted = kCode || kSP;
  // the training pair's bound: B4, and B4-SP for checks past one chunk
  // (which spills at either bound and ran faster at this one); B4-SP for
  // checks of one chunk takes SP's, where it does not spill
  static constexpr bool pair = kMode == kTrain && !(kSP && kChunks == 1);
  static constexpr int threads =
      pair    ? kTwoBlockThreads
      : kSP   ? kSPThreads
      : kCode ? (kMode == kDeploy ? kDeployThreads : kCodeThreads)
              : 1024;
  static constexpr int blocks =
      pair    ? 2
      : kSP   ? 1
      : kCode ? (kMode == kEarlyStop ? kEarlyStopBlocks
                 : kMode == kDeploy  ? kDeployBlocks
                                     : kCodeBlocks)
              : 1;
};

// kChunks: SP's checks have at most kChunks chunks of kSPRegDeg slots (1:
// every check fits one chunk, as on wman; B4-SP takes that instance where
// it can).  kExtra: 1, the instance that reads lab or writes last_out; 2,
// that also writes synd_out (see the notes above; the others ignore the
// three pointers).
template <int kMode, bool kSP, bool kCode, int kChunks = kSPChunks, int kExtra = 0>
__global__ void __launch_bounds__(LaunchBound<kMode, kSP, kCode, kChunks>::threads,
                                  LaunchBound<kMode, kSP, kCode, kChunks>::blocks)
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
                 int vn_mode, int offset_mode, int dim_cn, int dim_vn,
                 const uint8_t* __restrict__ lab, uint8_t* __restrict__ synd_out,
                 float* __restrict__ last_out) {
  constexpr bool kDep = kMode == kDeploy;
  constexpr bool kTr = kMode == kTrain;
  constexpr bool kLifted = LaunchBound<kMode, kSP, kCode>::lifted;
  static_assert(!kCode || (!kSP && !kTr), "the code state is QMS decode only");
  static_assert(!kCode || kMode != kEarlyStop,
                "the code state's early stop is fused_nms_kernel_word_stop");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Nz = N * z, Mz = M * z, Ez = E * z;
  const Graph gr = stage_table(tab, reinterpret_cast<int*>(smem_raw), N, M,
                               E, z, G);
  float* wc = reinterpret_cast<float*>(smem_raw + table_bytes(N, M, E));
  float* wu = wc + dim_cn;
  float* wv = wu + dim_cn;
  float* state = wc + ((2 * E + N + 3) & ~3);
  // kExtra: count against the codeword bits; write the syndrome flags
  const bool labelled = kExtra > 0 && !kTr && lab != nullptr;
  const bool track = kExtra == 2 && kMode == kFixed && synd_out != nullptr;
  const int ncnt = (kDep || track ? 4 : 2) * G;
  // float state (SP decode: after the lifted slot table)
  float* c2v = state + (kLifted && !kCode ? 2 * Ez : 0);
  float* tot = c2v + Ez * G;
  // code state
  int* ctl = reinterpret_cast<int*>(state);
  int2* ltab = reinterpret_cast<int2*>(kCode ? ctl + ((ncnt + kLutInts + 3) & ~3) : ctl);
  short* tot16 = reinterpret_cast<short*>(ltab + Ez);
  uint8_t* c2v8 = reinterpret_cast<uint8_t*>(tot16 + Nz * G);
  int* cnt = kCode ? ctl : reinterpret_cast<int*>(tot + Nz * G);
  int* lut = cnt + ncnt;  // code state only
  if (kLifted) stage_lifted(tab, ltab, E, z, gr.lg);
  // deploy: frozen[g] = word g's syndrome held at an iteration <= t-3 (as of
  // phase A of step t); unsat_at[g] = the last step whose phase B found an
  // unsatisfied check of word g (step s tests iteration s-1's decisions)
  int* frozen = cnt + 2 * G;
  int* unsat_at = frozen + G;
  // track: sflag[p][g] = phase B of a step of parity p found an unsatisfied
  // check of word g in the iteration it tested (two buffers, as the counts:
  // phase B sets one while the next step's statistics read the other)
  int* sflag = cnt + 2 * G;
  uint8_t* bits = reinterpret_cast<uint8_t*>(cnt + ncnt);  // float state only
  const bool need_bits = ucn || kDep || track;
  const bool stream = kTr && hist_out != nullptr;
  const int R = kSP ? 1 : (ucn ? 4 : 3);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lg = gr.lg;
  const bool qms = ms.qms();
  const int gt = tid & (G - 1);  // blockDim.x % G == 0: a thread keeps its word
  const int lgW = __ffs(W) - 1;
  const Rows rows0(tid >> lg, nthr >> lg, z);  // this thread's items
  const bool per_edge = cn_mode == 1 || cn_mode == 4;
  const int vn_per_bit = vn_mode == 2 || vn_mode == 5;
  // code state: the output bytes from a table per iteration (no or scalar
  // CN weights), with nlut = clipc + 2 entries per UCN mask
  const bool use_lut = kCode && (cn_mode == 0 || cn_mode == 3);
  const int nlut = ms.clipc + 2;

  const int b0 = blockIdx.x * G;
  const int b = b0 + gt;
  bool still_wrong = true;  // early stop, threads tid < G: word tid
  // this word's residual streams: tile b / W, lane b % W of it
  const size_t lane_w = (size_t)(b & (W - 1));
  float* hist_w = stream ? hist_out + ((size_t)(b >> lgW) * T * Ez << lgW) + lane_w
                         : nullptr;
  float* cres_w = stream && cres_out != nullptr
                      ? cres_out + ((size_t)(b >> lgW) * T * R * Mz << lgW) + lane_w
                      : nullptr;
  // the float state starts from C->V = 0; the code state never reads a
  // C->V slot at t = 0
  if (!kCode)
    for (int k = tid; k < Ez * G; k += nthr) c2v[k] = 0.0f;
  if (tid < 2 * G) cnt[tid] = 0;
  if (track && tid < 2 * G) sflag[tid] = 0;
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
    if (use_lut && t < T && tid < 2 * nlut) {  // phase B's output bytes
      const int um = tid >= nlut, mc = tid - um * nlut;
      float w = 1.0f;
      if (cn_mode > 0) {
        w = __ldg(w_cn + t);
        if (ucn) w = w * (1.0f - (float)um) + __ldg(w_ucn + t) * (float)um;
      }
      lut[um * kLutRow + mc] =
          code_out_bytes(ms, mc == nlut - 1 ? kPadC : mc, w, cn_mode, offset_mode);
    }
    int wrong = 0;
    for (Rows it = rows0; it.row < Nz; it.next()) {
      const int row = it.row, j = it.q;
      const int k = gr.at(row, gt);
      const float x = (b < B) ? __ldg(llr + (size_t)row * B + b) : 0.0f;
      // kExtra: the codeword bit of iteration t-1's count, read with the LLR
      const int lbit =
          (labelled && t > 0 && j < target && b < B) ? __ldg(lab + (size_t)row * B + b) : 0;
      float S;
      int Sc = 0;
      int dec = 0;  // the hard decision that phase B's parity reads
      if (kCode) {
        if (t > 0) Sc = gr.code_sum(c2v8, j, it.r, gt);
        S = __int2float_rn(Sc) * ms.u;
      } else {
        S = gr.bit_sum(c2v, j, it.r, gt);
      }
      if (t > 0) {  // APP and stats of iteration t-1
        const float base = qms ? ms.quantize(x) : x;
        if (kTr) {  // the pre-clip APP of the window; its sign is the clipped one's
          const float app = base + S;
          if (ucn) bits[k] = app >= 0.0f;
          if (b < B && t - 1 >= t0 && j < target)
            app_out[((size_t)(t - 1 - t0) * target * z + row) * B + b] = app;
          if (kExtra > 0 && t == T && j >= target && b < B && last_out != nullptr)
            last_out[(size_t)(row - target * z) * B + b] = app;
        } else {
          const bool write = b < B && (kDep ? live : t == T);
          // the float sum is -0 (not +0) only when every term is -0
          if (kCode && write && Sc == 0 && __float_as_int(base) == (int)0x80000000 &&
              gr.all_neg_zero(c2v8, j, it.r, gt))
            S = -0.0f;
          const float app = clip(base + S, ms.clip_llr);
          const bool bit = app >= 0.0f;
          if (j < target) wrong += bit ^ lbit;
          if (kCode) {
            if (t == T && need_bits) tot16[k] = (short)bit;  // the syndrome's
          } else if (need_bits) {
            bits[k] = bit;
          }
          if (write) app_out[(size_t)row * B + b] = app;
          dec = bit;
        }
      }
      if (t < T) {
        float lw = x;
        if (vn_mode > 0) lw = x * wv[vn_per_bit ? j : 0];
        if (qms) lw = ms.quantize(lw);
        if (ucn && t == 0) dec = lw >= 0.0f;
        if (kCode)
          tot16[k] = (short)(((ms.to_code(lw) + Sc) << 1) | (dec & need_bits));
        else
          tot[k] = lw + S;
        if (!kCode && ucn && t == 0) bits[k] = dec;
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
      if (track && t >= 2) {  // phase B of step t-1 tested iteration t-2
        if (b < B) synd_out[(size_t)(t - 2) * B + b] = !sflag[(p ^ 1) * G + tid];
        sflag[(p ^ 1) * G + tid] = 0;
      }
    }
    if (kMode == kEarlyStop && t > 0 && !__syncthreads_or(go)) {
      if (t < T) {
        // every word has decoded at least once: leave iteration t-1's APP
        // (the C->V state is still that of t-1) and zero the skipped rows
        for (Rows it = rows0; it.row < Nz; it.next()) {
          if (b < B) {
            const float x = __ldg(llr + (size_t)it.row * B + b);
            const float base = qms ? ms.quantize(x) : x;
            const float S = gr.bit_sum(c2v, it.q, it.r, gt);
            app_out[(size_t)it.row * B + b] = clip(base + S, ms.clip_llr);
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
      if (kCode) {
        const int2* lt = ltab + k0 * z + h;
        uint8_t* cw = c2v8 + g;
        const CodePass1 p1 =
            ms.qshift ? code_pass1<true>(ms, lt, cw, tot16 + g, k0, k1, z, t == 0)
                      : code_pass1<false>(ms, lt, cw, tot16 + g, k0, k1, z, t == 0);
        const int par = p1.par & 1;  // UCN mask, or the syndrome in deploy mode
        if (kDep && t > 0 && par) unsat_at[g] = t;  // all writers store t
        if (track && t > 0 && par) sflag[p * G + g] = 1;
        // an outgoing message is negative when the count of positive
        // incoming messages, plus one for a negative own message, is odd
        const int ppar = ((k1 - k0) ^ (p1.nneg >> 31)) & 1;
        // pass 2: the slot's byte from its min1 flag and sign
        if (!per_edge) {
          int K;
          if (use_lut) {
            const int* lr = lut + par * kLutRow;
            K = lr[min(p1.m2, nlut - 1)] | (lr[p1.m1] << 16);
          } else {
            const float w = cn_w(wc, wu, cn_col(cn_mode, i, 0), ucn, (float)par);
            K = code_out_bytes(ms, p1.m2, w, cn_mode, offset_mode) |
                (code_out_bytes(ms, p1.m1, w, cn_mode, offset_mode) << 16);
          }
          for (int q = k0; q < k1; ++q, lt += z) {
            uint8_t* c = cw + lt->x;
            const int xb = *c;
            const int sel = (((xb & 0x7f) != p1.m1) << 1) | (((xb >> 7) ^ ppar) & 1);
            *c = (uint8_t)__byte_perm(K, 0, sel);
          }
        } else {
          for (int q = k0; q < k1; ++q, lt += z) {
            uint8_t* c = cw + lt->x;
            const int xb = *c;
            const int ob = code_out_bytes(ms, (xb & 0x7f) == p1.m1 ? p1.m2 : p1.m1,
                                          cn_w(wc, wu, q, ucn, (float)par), cn_mode,
                                          offset_mode);
            *c = (uint8_t)(ob >> (8 * (((xb >> 7) ^ ppar) & 1)));
          }
        }
        continue;
      }
      float u = 0.0f;
      if (ucn || ((kDep || track) && t > 0)) {
        const int par = gr.check_parity(bits, i, h, g);
        u = (float)par;
        if (kDep && t > 0 && par) unsat_at[g] = t;  // all writers store t
        if (track && t > 0 && par) sflag[p * G + g] = 1;
      }
      // the check's weight this iteration (per edge: per slot, below)
      const float w_chk =
          (cn_mode > 0 && !per_edge) ? cn_w(wc, wu, cn_col(cn_mode, i, 0), ucn, u) : 1.0f;
      if (kSP) {
        // Two passes over the check's d slots, a chunk of kSPRegDeg at a
        // time (see the notes above).  The reverse pass derives each V->C
        // message and its tanh (kept in the slot's own C->V entry) and
        // accumulates the suffix products; the forward pass accumulates the
        // prefix products and writes each slot's C->V message (prefix x
        // suffix, clip, atanh, weight, ReLU, clip, sign) over the same
        // entry.  Streaming, the pre-clip V->C value goes out
        // before its slot is overwritten, and the UCN mask is the check's
        // one residual.
        if (stream && ucn && b < B)
          cres_w[((size_t)t * Mz + row) << lgW] = u;
        const int d = k1 - k0;
        const int2* lt = kLifted ? ltab + k0 * z + h : nullptr;
        // slot j's row offsets {C->V, bit total} (word 0)
        auto rows_of = [&](int j) -> int2 {
          if constexpr (kLifted) {
            return lt[j * z];
          } else {
            const int4 sd = gr.slot[k0 + j];
            const int sl = gr.sub(sd, h);
            return make_int2((sd.x + sl) << lg, (sd.y + sl) << lg);
          }
        };
        // the tanh of slot j's V->C message, kept in its C->V entry
        auto derive = [&](int j) -> float {
          const int2 o = rows_of(j);
          float* c = c2v + o.x + g;
          const float pre = tot[o.y + g] - *c;
          if (stream && b < B)
            hist_w[((size_t)t * Ez + (o.x >> lg)) << lgW] = pre;
          const float v = tanhf(-0.5f * clip(pre, ms.clip_llr));  // SP's v2c
          return *c = (v == 0.0f) ? 1.0f : v;
        };
        // slot j's C->V message from the running prefix product and its
        // suffix product
        float pre = 1.0f;
        auto emit = [&](int j, float suf_j) {
          float* c = c2v + rows_of(j).x + g;
          const float v = *c;
          float prod = (j == 0) ? suf_j : ((j == d - 1) ? pre : pre * suf_j);
          pre = (j == 0) ? v : pre * v;
          prod = fminf(fmaxf(prod, -kSPClip), kSPClip);
          const float out = -2.0f * atanhf(prod);
          float wmag = fabsf(out);
          if (cn_mode > 0) {
            const float w = per_edge ? cn_w(wc, wu, k0 + j, ucn, u) : w_chk;
            wmag = offset_mode ? wmag - w : wmag * w;
          }
          wmag = (wmag > 0.0f) ? wmag : 0.0f;
          wmag = clip(wmag, ms.clip_llr);  // SP's Msg::out
          const float so = (out > 0.0f) ? 1.0f : ((out < 0.0f) ? -1.0f : 0.0f);
          *c = wmag * so;
        };
        // registers (static indices after unrolling): the suffix products
        // of one chunk, and top[c - 1] the running product at the top of
        // chunk c >= 1 (selected by an unrolled compare, not indexed)
        // (kChunks = 1: every check fits one chunk, as on wman; no top)
        const int last = kChunks > 1 ? (d - 1) / kSPRegDeg : 0;
        float suf[kSPRegDeg], top[kChunks > 1 ? kChunks - 1 : 1];
        float acc = 1.0f;
        for (int c = last; c >= 0; --c) {
#pragma unroll
          for (int q = 1; q < kChunks; ++q)
            if (q == c) top[q - 1] = acc;
#pragma unroll
          for (int i = kSPRegDeg - 1; i >= 0; --i) {
            const int j = c * kSPRegDeg + i;
            if (j < d) {
              const float v = derive(j);
              suf[i] = acc;
              acc = (j == d - 1) ? v : acc * v;
            }
          }
        }
        for (int c = 0; c <= last; ++c) {
          if (c > 0) {  // the chunk's suffix products again, as above
            float s = 1.0f;
#pragma unroll
            for (int q = 1; q < kChunks; ++q)
              if (q == c) s = top[q - 1];
#pragma unroll
            for (int i = kSPRegDeg - 1; i >= 0; --i) {
              const int j = c * kSPRegDeg + i;
              if (j < d) {
                const float v = c2v[rows_of(j).x + g];
                suf[i] = s;
                s = (j == d - 1) ? v : s * v;
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kSPRegDeg; ++i)
            if (c * kSPRegDeg + i < d) emit(c * kSPRegDeg + i, suf[i]);
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
      // are all written.  Every thread reads the same flags: uniform.  (A
      // __syncthreads_or vote of each live word's threads in place of the
      // barrier and this loop was measured 2.8% slower.)
      bool done = true;
      for (int g = 0; g < G && b0 + g < B; ++g)
        done = done && (frozen[g] || unsat_at[g] != t);
      if (done) break;
    }
  }

  if (kDep) {
    if (t == T) {  // the syndrome of the last iteration, T-1
      for (Rows it = rows0; it.row < Mz; it.next())
        if (kCode ? gr.code_parity(ltab, tot16 + gt, it.q, it.r)
                  : gr.check_parity(bits, it.q, it.r, gt))
          unsat_at[gt] = T;
      __syncthreads();
    }
    if (tid < G && b < B) fail_out[b] = !frozen[tid] && unsat_at[tid] == T;
  }
  if (track) {  // the syndrome of the last iteration, T-1, into buffer T & 1
    for (Rows it = rows0; it.row < Mz; it.next())
      if (kCode ? gr.code_parity(ltab, tot16 + gt, it.q, it.r)
                : gr.check_parity(bits, it.q, it.r, gt))
        sflag[(T & 1) * G + gt] = 1;
    __syncthreads();
    if (tid < G && b < B) synd_out[(size_t)(T - 1) * B + b] = !sflag[(T & 1) * G + tid];
  }
}

// ---- the genie early stop per word (B2: QMS, code state) -----------------
//
// fused_nms_kernel_word_stop<kExtra> is B2, the early stop of the code
// state (kEarlyStop with kCode; the float state's early stop stays in the
// loop above, per block).  Each word stops at its own first correct
// iteration, as decode_stats_plain(..., group=1) does, and its lane of the
// block takes a new word:
//   - at most the resident blocks of the card run (persistent); each holds
//     G lanes, a word each, takes words from its current tile of G
//     consecutive words, keeps the next tile ahead, and claims a tile from a
//     device counter (`g_word_stop_claim`) as the tile ahead becomes its
//     current one.  The launch's last block to exit sets the counter back to 0, so
//     the next launch on the stream starts from word 0 with no other kernel
//     (two launches of one counter, kExtra's, must not overlap on two
//     streams);
//   - a lane is blockDim.x / G consecutive threads (48 on wman: two of every
//     three warps hold one lane alone) and its state is its own run of
//     shared memory, [G][rows] and not the loop's [rows][G]: a lane whose
//     word has stopped leaves its warps idle at the barrier, which frees the
//     SM for the other blocks (were the lanes interleaved in every warp, as
//     in the loop above, a stopped lane would idle only its threads, and a
//     warp would cost as much as before);
//   - every lane keeps its own iteration t in shared memory beside the
//     counts; the lanes step together (three barriers a step, as the loop
//     above), each at its own t: phase A and phase B read their lane's t,
//     its weights (from device memory; the output-byte tables of all T, when
//     they fit the block's room, staged once per block), `first` of
//     code_pass1 and the UCN decision at t = 0;
//   - after a step's statistics thread g of warp 0 ends lane g's word when it
//     was correct at t-1 or reached T, and the warp refills the ended lanes
//     (one ballot; one atomic when a tile is claimed).  A word that stopped
//     at t < T skips phase B, so its C->V state stays that of t-1; while the
//     other lanes run phase B, the lane's own threads, idle otherwise, write
//     its APP from that state, zero its rows t..T-1 and copy the next word's
//     LLR codes into the lane.  The codes of a tile are staged once, when it
//     is claimed, by the whole block at the start of the next phase A (a
//     warp reads 32 / G rows of the tile's G consecutive words: each sector
//     once), as int8 codes of the QMS unit u where each is one exactly (-128:
//     -0), as the channel's QMS LLRs are; the block keeps its current tile
//     and the tile ahead.  A word with another value reads it from device
//     memory at every step.  So a word's APP and LLRs cost no step of their
//     own, and the steps read no LLR from device memory;
//   - the graph table, the lifted slot table and the output-byte tables are
//     staged once per block, not once per G words;
//   - the instance with kRead takes a whole host read of K batches, `llr`
//     [K][N*z][B] (`words` = K*B; word w is column w % B of batch w / B,
//     so a tile may straddle two batches), and `totals` (an int64 triple,
//     zero-filled by the caller) in place of the rows and the APP, and
//     writes neither: a word that ends at t = T still wrong (it was wrong
//     at every iteration, or it would have stopped) adds its bit errors and
//     itself to its block's shared totals, and each block adds them to the
//     triple at its exit: [bit errors at the last iteration, frames wrong
//     there, frames wrong at every iteration], the simulator's genie
//     counters, which are the reductions of the rows (a word that was ever
//     correct has stopped, so its last row is 0).  A read drains once, not
//     once per batch, and no kernel reduces its rows.  The instances
//     without kRead (one batch, its rows and APP) compile as they did
//     before it.
// Under a profiler (`engage`) each block adds, at its exit, its lane-steps
// (G times its loop entries, idle lanes included) and its words to the
// device pair `g_word_stop_engage` (utils.profiling.snapshot() reads it).

__device__ unsigned int g_word_stop_claim[2][2];  // [kExtra]: next tile, blocks done
                                                  // (a read uses kExtra 0's)
__device__ unsigned long long g_word_stop_engage[2];  // lane-steps, words

constexpr int kWordStopCtl = 16;  // the block's ints of the word stop's control

// The shared memory of fused_nms_kernel_word_stop, as byte offsets
// (ops/fused_decoder.py::_smem_bytes with early_stop computes its size):
// graph table | control int: counts [2][G], then per lane its word, t, the
// word that stopped this step, whether phase B runs, its LLR flags and
// where its next word's codes are, [G] each, then kWordStopCtl of the block
// (padded to 16 bytes) | the output-byte tables uint16 [lut_iters][kLutInts]
// (padded to 16 bytes; lut_iters 0: none) | the lifted slot table ushort2
// [E*z] (each slot's two row offsets in 16 bits: a warp's 32 slots are one
// 128-byte read) | per lane: bit totals int16 [G][N*z], LLR codes int8
// [G][N*z] | two tile buffers of LLR codes int8 [2][N*z][G] | per lane: C->V
// bytes [G][E*z].  The launch passes it by value, so the kernel reads the
// offsets from its parameters and keeps no register for them.
struct WordStopLayout {
  int cnt, lut, ltab, tot, xc, xt, c2v, bytes;
};

__host__ __device__ __forceinline__ WordStopLayout word_stop_layout(int N, int M, int z,
                                                                    int E, int G,
                                                                    int lut_iters) {
  WordStopLayout L;
  L.cnt = table_bytes(N, M, E);
  L.lut = L.cnt + 4 * ((8 * G + kWordStopCtl + 3) & ~3);
  L.ltab = L.lut + ((2 * kLutInts * lut_iters + 15) & ~15);
  L.tot = L.ltab + 4 * E * z;
  L.xc = L.tot + 2 * N * z * G;
  L.xt = L.xc + N * z * G;
  L.c2v = L.xt + 2 * N * z * G;
  L.bytes = L.c2v + E * z * G;
  return L;
}

// The lifted slot table of `stage_lifted` with unshifted rows (lg 0), each
// offset in 16 bits (E*z < 65536; the caller synchronises before use).
__device__ void stage_lifted16(const int* __restrict__ tab, ushort2* dst, int E,
                               int z) {
  const int4* slot = reinterpret_cast<const int4*>(tab);
  for (int k = threadIdx.x; k < E * z; k += blockDim.x) {
    const int q = k / z, h = k - q * z;
    const int4 sd = __ldg(slot + q);
    const int sl = h + sd.z >= z ? h + sd.z - z : h + sd.z;
    dst[k] = make_ushort2((unsigned short)(sd.x + sl), (unsigned short)(sd.y + sl));
  }
}

// Warp 0 (all 32 threads): the next words of the block for the lanes of
// `want` (thread g < G for lane g): the unstarted words of the block's
// current tile in turn, then those of its tile ahead, whose LLR codes are
// staged already; *src: the tile buffer (bit 8) and column of the word's
// codes, and bit 16 set where they are not all codes.  When the current
// tile is used up the tile ahead becomes current and the block claims the
// next tile of G words from `claim`, to be staged by the next phase A.  -1
// where the launch's `words` are all taken.  blk (see the
// kernel): [0] next unstarted word, [1] end of the current tile, [2] set
// once a claim found no word, [6] base of the tile ahead (-1: none), [7] its
// end, [8] the current tile's buffer, [9] the tile ahead is to be staged,
// [10 + buffer] its words whose LLRs are not all codes, [12] base of the
// current tile.
__device__ __forceinline__ int claim_words(bool want, int* blk, unsigned* claim,
                                           int G, int words, int* src) {
  const unsigned need = __ballot_sync(0xffffffffu, want);
  if (!need) return -1;
  const int lane = threadIdx.x;
  const int nw = __popc(need), nxt = blk[0], avail = blk[1] - nxt;
  const int cur = blk[8], abase = blk[6];
  const int aavail = abase >= 0 ? blk[7] - abase : 0;
  const int rank = __popc(need & ((1u << lane) - 1u));
  int w = -1, buf = cur, col = 0;
  if (rank < avail) {
    w = nxt + rank;
    col = w - blk[12];
  } else if (rank < avail + aavail) {
    w = abase + rank - avail;
    buf = cur ^ 1;
    col = w - abase;
  }
  if (w >= 0) *src = (buf << 8) | col | ((blk[10 + buf] >> col & 1) << 16);
  const bool promote = nw >= avail && abase >= 0;
  int base = words;
  if (promote && !blk[2]) {
    if (lane == 0) base = (int)atomicAdd(claim, (unsigned)G);
    base = __shfl_sync(0xffffffffu, base, 0);
  }
  __syncwarp();
  if (lane == 0) {
    if (!promote) {
      blk[0] = min(nxt + nw, blk[1]);
    } else {
      blk[8] = cur ^ 1;
      blk[12] = abase;
      blk[1] = blk[7];
      blk[0] = min(abase + nw - avail, blk[1]);
      if (base < words) {  // into the old current tile's buffer
        blk[6] = base;
        blk[7] = min(base + G, words);
        blk[9] = 1;
        blk[10 + cur] = 0;
      } else {
        blk[6] = -1;
        blk[2] = 1;
      }
    }
  }
  return want ? w : -1;
}

// The offset of word w's first LLR in a read's `llr` [K][N*z][B]: column
// w % B of batch w / B.
__device__ __forceinline__ size_t word_col(int w, int B, int Nz) {
  const int k = w / B;
  return (size_t)k * Nz * B + (w - k * B);
}

// All threads: the LLRs of the G words [base, end) as int8 codes of u where
// each is one exactly (-128: -0), into the tile buffer `xt` [N*z][G]; bit w
// of `off` set where word w's are not all codes.  A warp reads 32 / G rows
// of the tile's consecutive words, so each sector is read once for its G
// words (four loads in flight).  kRead: `llr` is a read's, and each thread
// finds its word's column once (a tile may straddle two batches).
template <bool kRead>
__device__ __forceinline__ void stage_tile(const float* __restrict__ llr, int base,
                                           int end, int B, int Nz, int G,
                                           const Msg& ms, signed char* xt, int* off) {
  const int lgG = __ffs(G) - 1, w = threadIdx.x & (G - 1);  // blockDim.x % G == 0
  const bool in = base + w < end;
  const float* col = kRead ? llr + word_col(base + w, B, Nz) : llr;
  bool odd = false;
#pragma unroll 4
  for (int e = threadIdx.x; e < Nz << lgG; e += blockDim.x) {
    const float x = in ? __ldg(kRead ? col + (size_t)(e >> lgG) * B
                                     : llr + (size_t)(e >> lgG) * B + base + w)
                       : 0.0f;
    const int cx = __float2int_rn(x * ms.uinv);
    odd = odd || !(cx >= -127 && cx <= 127 && __int2float_rn(cx) * ms.u == x);
    xt[e] = (signed char)(cx == 0 && __float_as_int(x) < 0 ? -128 : cx);
  }
  if (odd && in) atomicOr(off, 1 << w);
}

// The value of a staged LLR code (-128: -0).
__device__ __forceinline__ float llr_of_code(int c, float u) {
  return c == -128 ? -0.0f : __int2float_rn(c) * u;
}

// A lane's threads (thread k of tpl): the codes of its word from column
// `src & 0xff` of tile buffer `src >> 8 & 1` of `xt` [2][N*z][G] into the
// lane's `xc`, and bit 0 of `flag` where they are not all codes (bit 16 of
// `src`).  Nothing for src < 0.
__device__ __forceinline__ void copy_codes(const signed char* xt, int src, int Nz,
                                           int G, int k, int tpl, signed char* xc,
                                           int* flag) {
  if (src < 0) return;
  const signed char* t = xt + (size_t)(src >> 8 & 1) * Nz * G + (src & 0xff);
  for (int row = k; row < Nz; row += tpl) xc[row] = t[row * G];
  if (k == 0 && (src >> 16 & 1)) atomicOr(flag, 1);
}

// kRead: a host read (`totals`, `read_words`; see above); the parameters
// it adds come last, so the instances without it read theirs as before.
template <int kExtra, bool kRead = false>
__global__ void __launch_bounds__(LaunchBound<kEarlyStop, false, true>::threads,
                                  LaunchBound<kEarlyStop, false, true>::blocks)
fused_nms_kernel_word_stop(const float* __restrict__ llr,
                           const float* __restrict__ w_cn,
                           const float* __restrict__ w_ucn,
                           const float* __restrict__ w_vn,
                           const int* __restrict__ tab,
                           float* __restrict__ app_out,
                           uint8_t* __restrict__ err_out,
                           int* __restrict__ nerr_out,
                           int N, int M, int z, int E, int T, int B, int G,
                           int target, Msg ms, int cn_mode, int ucn,
                           int vn_mode, int offset_mode, int dim_cn, int dim_vn,
                           WordStopLayout L, int engage,
                           const uint8_t* __restrict__ lab,
                           unsigned long long* __restrict__ totals, int read_words) {
  static_assert(!kRead || kExtra == 0, "a read takes no labels");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Nz = N * z, Mz = M * z, Ez = E * z;
  const int words = kRead ? read_words : B;
  // a lane's rows are its own run of shared memory: the graph's rows
  // unshifted (lg 0)
  const Graph gr = stage_table(tab, reinterpret_cast<int*>(smem_raw), N, M,
                               E, z, 1);
  int* cnt = reinterpret_cast<int*>(smem_raw + L.cnt);
  int* lw = cnt + 2 * G;    // lane g's word (-1: none)
  int* lt = lw + G;         // its iteration t
  int* ldone = lt + G;      // its word that stopped at t < T this step (-1)
  int* lrun = ldone + G;    // phase B runs for lane g this step
  int* lflag = lrun + G;    // bit 0: its word's LLRs are not all codes; bit 1: ldone's
  int* lsrc = lflag + G;    // where its next word's codes are (claim_words)
  int* blk = lsrc + G;      // claim_words' and: [3] alive, [4] steps, [5] words,
                            // [13] bit errors and [14] words wrong at every
                            // iteration (the totals)
  unsigned short* lut = reinterpret_cast<unsigned short*>(smem_raw + L.lut);
  ushort2* ltab = reinterpret_cast<ushort2*>(smem_raw + L.ltab);
  unsigned* claim = g_word_stop_claim[kExtra];
  const bool labelled = kExtra > 0 && lab != nullptr;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int tpl = nthr / G;  // threads per lane (blockDim.x % G == 0)
  const int g = tid / tpl;   // this thread's lane
  const int kl = tid - g * tpl;  // and its index there
  const Rows rows0(kl, tpl, z);  // its items of the lane's rows
  short* tot_g = reinterpret_cast<short*>(smem_raw + L.tot) + g * Nz;
  signed char* xc_g = reinterpret_cast<signed char*>(smem_raw + L.xc) + g * Nz;
  signed char* xt = reinterpret_cast<signed char*>(smem_raw + L.xt);
  uint8_t* c2v_g = smem_raw + L.c2v + g * Ez;
  const bool per_edge = cn_mode == 1 || cn_mode == 4;
  const bool vn_per_bit = vn_mode == 2 || vn_mode == 5;
  const bool use_lut = L.ltab > L.lut;  // the tables of every iteration
  const int nlut = ms.clipc + 2;

  stage_lifted16(tab, ltab, E, z);
  if (use_lut)  // the output bytes of every iteration (see the loop above)
    for (int k = tid; k < T * 2 * nlut; k += nthr) {
      const int t = k / (2 * nlut), r = k - t * 2 * nlut;
      const int um = r >= nlut, mc = r - um * nlut;
      float w = 1.0f;
      if (cn_mode > 0) {
        w = __ldg(w_cn + t);
        if (ucn) w = w * (1.0f - (float)um) + __ldg(w_ucn + t) * (float)um;
      }
      lut[t * kLutInts + um * kLutRow + mc] = (unsigned short)code_out_bytes(
          ms, mc == nlut - 1 ? kPadC : mc, w, cn_mode, offset_mode);
    }
  if (tid < 2 * G) cnt[tid] = 0;
  if (tid < G) {
    ldone[tid] = -1;
    lflag[tid] = 0;
  }
  if (tid == 0) {  // the first tile, staged as the tile ahead
    for (int k = 0; k < kWordStopCtl; ++k) blk[k] = 0;
    const int base = (int)atomicAdd(claim, (unsigned)G);
    blk[6] = base < words ? base : -1;
    blk[7] = min(base + G, words);
    blk[2] = base >= words;
  }
  __syncthreads();
  if (blk[6] >= 0)
    stage_tile<kRead>(llr, blk[6], blk[7], B, Nz, G, ms, xt + Nz * G, blk + 11);
  __syncthreads();
  if (tid < 32) {
    int src = -1;
    const int w = claim_words(tid < G, blk, claim, G, words, &src);
    const int taken = __popc(__ballot_sync(0xffffffffu, w >= 0));
    if (tid < G) {
      lw[tid] = w;
      lt[tid] = 0;
      lsrc[tid] = src;
    }
    if (tid == 0) {
      blk[3] = taken > 0;
      blk[5] = taken;
    }
  }
  __syncthreads();
  copy_codes(xt, lsrc[g], Nz, G, kl, tpl, xc_g, lflag + g);
  __syncthreads();

  for (int p = 0; blk[3]; p ^= 1) {
    // this step of lane g: its word b at iteration t
    const int b = lw[g], t = lt[g];
    const bool live = b >= 0;
    const bool app_cur = live && t > 0;  // the APP and count of t-1
    // ---- phase A: per lifted bit ------------------------------------------
    if (blk[9]) {  // all threads: the tile ahead, claimed at the last step
      const int ahead = blk[8] ^ 1;
      stage_tile<kRead>(llr, blk[6], blk[7], B, Nz, G, ms, xt + ahead * Nz * G, blk + 10 + ahead);
    }
    int wrong = 0;
    if (live) {
      const bool off = lflag[g] & 1;  // an LLR of the word that is no code
      const float wvs = (t < T && vn_mode > 0 && !vn_per_bit)
                            ? __ldg(w_vn + (size_t)t * dim_vn) : 1.0f;
      for (Rows it = rows0; it.row < Nz; it.next()) {
        const int row = it.row, j = it.q;
        const float x = off ? __ldg(kRead ? llr + word_col(b, B, Nz) + (size_t)row * B
                                          : llr + (size_t)row * B + b)
                            : llr_of_code(xc_g[row], ms.u);
        int Sc = 0;
        int dec = 0;  // the hard decision that phase B's parity reads
        if (app_cur) {
          Sc = gr.code_sum(c2v_g, j, it.r, 0);
          const float base = ms.quantize(x);
          float S = __int2float_rn(Sc) * ms.u;
          // the float sum is -0 (not +0) only when every term is -0
          if (t == T && Sc == 0 && __float_as_int(base) == (int)0x80000000 &&
              gr.all_neg_zero(c2v_g, j, it.r, 0))
            S = -0.0f;
          const float app = clip(base + S, ms.clip_llr);
          const int lbit =
              (labelled && j < target) ? __ldg(lab + (size_t)row * B + b) : 0;
          dec = app >= 0.0f;
          if (j < target) wrong += dec ^ lbit;
          if (t == T && app_out != nullptr) app_out[(size_t)row * B + b] = app;
        }
        if (t < T) {
          float lw_x = x;
          if (vn_mode > 0)
            lw_x = x * (vn_per_bit ? __ldg(w_vn + (size_t)t * dim_vn + j) : wvs);
          lw_x = ms.quantize(lw_x);
          if (ucn && t == 0) dec = lw_x >= 0.0f;
          tot_g[row] = (short)(((ms.to_code(lw_x) + Sc) << 1) | (dec & ucn));
        }
      }
    }
    if (app_cur && wrong) atomicAdd(&cnt[p * G + g], wrong);
    __syncthreads();
    // ---- statistics, stops and refills: warp 0, thread l for lane l -------
    if (tid < 32) {
      bool ended = false;
      int bl = -1;
      if (tid < G) {
        bl = lw[tid];
        const int tl = lt[tid];
        bool run = bl >= 0 && tl < T;
        int done = -1;
        if (bl >= 0 && tl > 0) {
          const int n = cnt[p * G + tid];
          if (n == 0 || tl == T) {  // correct at t-1, or wrong at every iteration
            ended = true;
            run = false;
            if (tl < T) done = bl;  // its APP and rows are due
            if (kRead && n > 0) {  // ends at T, wrong at every iteration
              atomicAdd(blk + 13, n);
              atomicAdd(blk + 14, 1);
            }
          }
        }
        cnt[(p ^ 1) * G + tid] = 0;
        // bit 1: the stopped word's LLRs are not all codes; bit 0, the next
        // word's, is set as they are staged
        if (ended) lflag[tid] = (lflag[tid] & 1) << 1;
        ldone[tid] = done;
        lrun[tid] = run;
        lt[tid] = ended ? 0 : tl + 1;
      }
      if (tid == 0) blk[9] = 0;
      int src = -1;
      const int w = claim_words(ended, blk, claim, G, words, &src);
      const unsigned got = __ballot_sync(0xffffffffu, w >= 0);
      if (ended) {
        lw[tid] = w;
        lsrc[tid] = src;
      }
      const unsigned alive =
          __ballot_sync(0xffffffffu, tid < G && (ended ? w : bl) >= 0);
      if (tid == 0) {
        blk[3] = alive != 0;
        blk[4] += 1;  // loop entries
        blk[5] += __popc(got);
      }
    }
    __syncthreads();
    if (!kRead && kl == 0 && app_cur) {  // the lane's row t-1 (its count
      const int n = cnt[p * G + g];       // stays until the next statistics)
      err_out[(size_t)(t - 1) * B + b] = n > 0;
      nerr_out[(size_t)(t - 1) * B + b] = n;
    }
    // ---- phase B: per lifted check, the lanes that go on ------------------
    if (lrun[g]) {
      const unsigned short* lut_t = lut + t * kLutInts;
      const float* wc = cn_mode > 0 ? w_cn + (size_t)t * dim_cn : nullptr;
      const float* wu = ucn ? w_ucn + (size_t)t * dim_cn : nullptr;
      for (Rows it = rows0; it.row < Mz; it.next()) {
        const int i = it.q, h = it.r;
        const int k0 = gr.cn_ptr[i], k1 = gr.cn_ptr[i + 1];
        const ushort2* lt2 = ltab + k0 * z + h;
        const CodePass1 p1 =
            ms.qshift ? code_pass1<true>(ms, lt2, c2v_g, tot_g, k0, k1, z, t == 0)
                      : code_pass1<false>(ms, lt2, c2v_g, tot_g, k0, k1, z, t == 0);
        const int par = p1.par & 1;  // the UCN mask
        const int ppar = ((k1 - k0) ^ (p1.nneg >> 31)) & 1;
        if (!per_edge) {
          unsigned K;
          if (use_lut) {
            const unsigned short* lr = lut_t + par * kLutRow;
            K = (unsigned)lr[min(p1.m2, nlut - 1)] | ((unsigned)lr[p1.m1] << 16);
          } else {
            const float w = cn_mode > 0 ? cn_w(wc, wu, cn_col(cn_mode, i, 0), ucn, (float)par)
                                        : 1.0f;
            K = (unsigned)code_out_bytes(ms, p1.m2, w, cn_mode, offset_mode) |
                ((unsigned)code_out_bytes(ms, p1.m1, w, cn_mode, offset_mode) << 16);
          }
          for (int q = k0; q < k1; ++q, lt2 += z) {
            uint8_t* c = c2v_g + lt2->x;
            const int xb = *c;
            const int sel = (((xb & 0x7f) != p1.m1) << 1) | (((xb >> 7) ^ ppar) & 1);
            *c = (uint8_t)__byte_perm(K, 0, sel);
          }
        } else {
          for (int q = k0; q < k1; ++q, lt2 += z) {
            uint8_t* c = c2v_g + lt2->x;
            const int xb = *c;
            const int ob = code_out_bytes(ms, (xb & 0x7f) == p1.m1 ? p1.m2 : p1.m1,
                                          cn_w(wc, wu, q, ucn, (float)par), cn_mode,
                                          offset_mode);
            *c = (uint8_t)(ob >> (8 * (((xb >> 7) ^ ppar) & 1)));
          }
        }
      }
    } else if (live) {
      // ---- the lane's word ended: while the other lanes run phase B, its
      // threads write the APP of a word that stopped at t - 1 < T (its
      // C->V state is still that of t - 1) and zero its rows t..T-1, then
      // stage the LLR codes of the lane's next word
      const int bd = ldone[g];
      if (bd >= 0) {
        for (int r = t + kl; !kRead && r < T; r += tpl) {
          err_out[(size_t)r * B + bd] = 0;
          nerr_out[(size_t)r * B + bd] = 0;
        }
        const bool off = lflag[g] & 2;
        for (Rows it = rows0; app_out != nullptr && it.row < Nz; it.next()) {
          const int row = it.row;
          const float base = ms.quantize(off ? __ldg(llr + (size_t)row * B + bd)
                                             : llr_of_code(xc_g[row], ms.u));
          const int Sc = gr.code_sum(c2v_g, it.q, it.r, 0);
          float S = __int2float_rn(Sc) * ms.u;
          if (Sc == 0 && __float_as_int(base) == (int)0x80000000 &&
              gr.all_neg_zero(c2v_g, it.q, it.r, 0))
            S = -0.0f;
          app_out[(size_t)row * B + bd] = clip(base + S, ms.clip_llr);
        }
      }
      copy_codes(xt, lsrc[g], Nz, G, kl, tpl, xc_g, lflag + g);
    }
    __syncthreads();
  }

  if (tid == 0) {
    if (engage) {
      atomicAdd(&g_word_stop_engage[0], (unsigned long long)blk[4] * G);
      atomicAdd(&g_word_stop_engage[1], (unsigned long long)blk[5]);
    }
    if (kRead && blk[14] > 0) {
      atomicAdd(totals, (unsigned long long)blk[13]);
      atomicAdd(totals + 1, (unsigned long long)blk[14]);
      atomicAdd(totals + 2, (unsigned long long)blk[14]);
    }
    __threadfence();
    if (atomicAdd(claim + 1, 1u) == gridDim.x - 1) {  // the launch's last block
      claim[0] = 0;
      claim[1] = 0;
    }
  }
}

// Blocks of kernel `kern` that one SM holds at `threads` threads and `smem`
// bytes of dynamic shared memory (0 when the query fails).
template <class Kernel>
int resident_blocks_of(Kernel* kern, int threads, int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

// The same for fused_nms_kernel<kMode, kSP, kCode>, or, for the code
// state's early stop, fused_nms_kernel_word_stop.
template <int kMode, bool kSP, bool kCode>
int resident_blocks(int threads, int smem) {
  if constexpr (kMode == kEarlyStop && kCode)
    return resident_blocks_of(fused_nms_kernel_word_stop<0>, threads, smem);
  else
    return resident_blocks_of(fused_nms_kernel<kMode, kSP, kCode>, threads, smem);
}

// One launch of fused_nms_kernel<kMode, kSP, kCode, kChunks, kExtra> on
// `stream` with `smem` bytes of dynamic shared memory per block of G words
// (lab, synd and last: kExtra's, else null).  Returns -2 when `smem` is not
// the layout's size, else cudaGetLastError() after the launch (0 =
// launched).
template <int kMode, bool kSP, bool kCode, int kChunks = kSPChunks, int kExtra = 0>
int launch(const void* llr, const void* w_cn, const void* w_ucn,
           const void* w_vn, const void* tab, void* app, void* err,
           void* nerr, void* iters, void* fail, void* hist, void* cres,
           int N, int M, int z, int E, int T, int B, int G, int W, int threads,
           int smem, int target, int t0, Msg ms, int cn_mode, int ucn,
           int vn_mode, int offset_mode, int dim_cn, int dim_vn,
           cudaStream_t stream, const void* lab = nullptr, void* synd = nullptr,
           void* last = nullptr) {
  const bool track = kExtra == 2 && kMode == kFixed && synd != nullptr;
  if (smem != decode_smem_bytes(N, M, z, E, G, ucn, kMode == kDeploy, kCode,
                                LaunchBound<kMode, kSP, kCode>::lifted, track))
    return -2;
  auto* kern = fused_nms_kernel<kMode, kSP, kCode, kChunks, kExtra>;
  cudaError_t st = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return (int)st;
  const int blocks = (B + G - 1) / G;
  kern<<<blocks, threads, smem, stream>>>(
      (const float*)llr, (const float*)w_cn, (const float*)w_ucn,
      (const float*)w_vn, (const int*)tab, (float*)app, (uint8_t*)err,
      (int*)nerr, (int*)iters, (uint8_t*)fail, (float*)hist, (float*)cres,
      N, M, z, E, T, B, G, W, target, t0, ms, cn_mode, ucn, vn_mode,
      offset_mode, dim_cn, dim_vn, (const uint8_t*)lab, (uint8_t*)synd,
      (float*)last);
  return (int)cudaGetLastError();
}

// One launch of fused_nms_kernel_word_stop<kExtra, kRead> (lab: kExtra's,
// else null; `totals` and `words`: kRead's) on `stream`: at most the
// blocks that the card holds at once, G lanes each.  Returns the first CUDA
// error of the queries and the launch (0 = launched).
template <int kExtra, bool kRead>
int launch_word_stop_as(const float* llr, const float* w_cn, const float* w_ucn,
                        const float* w_vn, const int* tab, float* app, uint8_t* err,
                        int* nerr, int N, int M, int z, int E, int T, int B, int G,
                        int threads, int smem, int target, Msg ms, int cn_mode, int ucn,
                        int vn_mode, int offset_mode, int dim_cn, int dim_vn,
                        const WordStopLayout& L, int engage, cudaStream_t stream,
                        const uint8_t* lab, unsigned long long* totals, int words) {
  auto* kern = fused_nms_kernel_word_stop<kExtra, kRead>;
  // the blocks the card holds at once, per instance, card and shape: asked
  // once (a CUDA graph captures a launch per batch or read, and the query
  // costs more than the launch)
  static int known[64][3];  // [card]: threads, smem, blocks
  int dev = 0;
  cudaError_t st = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st == cudaSuccess) st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return (int)st;
  int* k = known[dev & 63];
  if (k[0] != threads || k[1] != smem) {
    int sms = 0, per_sm = 0;
    st = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (st == cudaSuccess)
      st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (st != cudaSuccess) return (int)st;
    k[2] = (per_sm > 0 ? per_sm : 1) * sms;
    k[1] = smem;
    k[0] = threads;
  }
  const int tiles = (words + G - 1) / G, resident = k[2];
  const int blocks = tiles < resident ? tiles : resident;
  kern<<<blocks, threads, smem, stream>>>(
      llr, w_cn, w_ucn, w_vn, tab, app, err, nerr, N, M, z, E, T, B, G, target, ms,
      cn_mode, ucn, vn_mode, offset_mode, dim_cn, dim_vn, L, engage, lab, totals,
      words);
  return (int)cudaGetLastError();
}

// One launch of B2.  `lut`: the output-byte tables of all T iterations are
// staged (no or scalar CN weights only).  `engage`: add the launch's
// lane-steps and words to `g_word_stop_engage`.  `app` null: write no APP
// (a caller that only counts).  `words`: B for one batch, whose rows (and
// APP) it writes; with `totals`, K*B for a read of K batches (the kRead
// instance), which takes no rows, APP or labels.  Returns -2 when `smem`
// is not the layout's size, -3 for a read that breaks those rules, else
// that of launch_word_stop_as.
template <int kExtra>
int launch_word_stop(const void* llr, const void* w_cn, const void* w_ucn,
                     const void* w_vn, const void* tab, void* app, void* err,
                     void* nerr, void* totals, int N, int M, int z, int E, int T, int B,
                     int words, int G, int threads, int smem, int target, Msg ms,
                     int cn_mode, int ucn, int vn_mode, int offset_mode, int dim_cn,
                     int dim_vn, int lut, int engage, cudaStream_t stream,
                     const void* lab) {
  const WordStopLayout L = word_stop_layout(N, M, z, E, G, lut ? T : 0);
  if (smem != L.bytes || (lut && cn_mode != 0 && cn_mode != 3)) return -2;
#define WORD_STOP_ARGS                                                        \
  (const float*)llr, (const float*)w_cn, (const float*)w_ucn, (const float*)w_vn, \
      (const int*)tab, (float*)app, (uint8_t*)err, (int*)nerr, N, M, z, E, T, B, G, \
      threads, smem, target, ms, cn_mode, ucn, vn_mode, offset_mode, dim_cn,     \
      dim_vn, L, engage, stream, (const uint8_t*)lab, (unsigned long long*)totals, \
      words
  if (totals == nullptr)
    return words == B ? launch_word_stop_as<kExtra, false>(WORD_STOP_ARGS) : -3;
  if constexpr (kExtra == 0)
    if (!app && !err && !nerr && !lab && B > 0 && words % B == 0)
      return launch_word_stop_as<0, true>(WORD_STOP_ARGS);
#undef WORD_STOP_ARGS
  return -3;
}

}  // namespace
