// Channel LLRs of one batch in one pass: BPSK over AWGN, 2y/sigma^2, the
// QMS grid, the punctured and shortened rows and the random-codeword fold.
//
// Replaces the elementwise XLA fusion that the JAX step makes, after the
// RNG, of ldpc_error_floor_tpu/channel/awgn.py:61-89 (AWGNChannel.sample,
// sample_codewords, _llr) and the sign fold of
// ldpc_error_floor_tpu/sim/fer.py:166.  The plain PyTorch version is
// channel/awgn.py::AWGNChannel.llr_plain; the two agree bit for bit, signs
// of zero included.
//
// What bounds it on an H100: device memory.  Each element reads its noise
// (and with codewords its bit) once and writes its LLR once, 8 bytes (12)
// against about 12 simple f32 operations and one IEEE divide (two under
// QMS), far below the card's operations per byte.  So the design only has
// to stream: one thread per four consecutive words of a row, 16-byte loads
// and stores with neighbouring threads on neighbouring addresses, each
// thread's four sigmas loaded once; a batch that is not a multiple of four
// words (or a pointer that is not 16-byte aligned) takes the same layout
// with scalar loads and a guarded tail.  It launches on the caller's
// stream, allocates nothing and does not synchronise, so a CUDA graph
// captures it.
//
// Rounding: each multiply, add and divide is its own IEEE operation,
// rounded to nearest (__fmul_rn, __fadd_rn, __fdiv_rn are never contracted
// into an FMA, and the divide is never a reciprocal multiply), in the
// plain version's order:
//   y   = -1 + noise*sigma, or with bits s + noise*sigma, s = 2b - 1;
//   llr = (2y) / (sigma*sigma);
//   QMS: clamp(rint(llr/step)*step, -clip, clip), rint half to even as
//        torch.round and jnp.round, fminf/fmaxf keep -0;
//   llr = llr*(1-p) + punct_val*p, p in {0, 1} from the punctured rows
//        (this blend turns -0 into +0, as the plain version's does);
//   llr = llr*(1-s) + (-clip_llr)*s, s in {0, 1} from the shortened rows;
//   fold: llr * (1 - 2b) (a word bit of 1 flips the sign, of zero too).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Args {
  int quant;           // QMS: round to the grid and clip
  float step, clip;    // the QMS grid (ops/ste.py::qms_grid)
  float punct_val;     // 0.001 under SP, else 0
  float neg_clip_llr;  // -clip_llr, the shortened rows' LLR
  int p_lo, p_hi;      // punctured rows [p_lo, p_hi), 0-indexed
  int s_lo, s_hi;      // shortened rows [s_lo, s_hi)
  int fold;            // multiply by 1 - 2b
};

__device__ __forceinline__ float llr_of(float n, float sig, float b, bool bits,
                                        float p, float s, const Args& a) {
  const float ns = __fmul_rn(n, sig);
  const float y = __fadd_rn(bits ? __fsub_rn(__fmul_rn(2.f, b), 1.f) : -1.f, ns);
  float llr = __fdiv_rn(__fmul_rn(2.f, y), __fmul_rn(sig, sig));
  if (a.quant)
    llr = fminf(fmaxf(__fmul_rn(rintf(__fdiv_rn(llr, a.step)), a.step), -a.clip),
                a.clip);
  llr = __fadd_rn(__fmul_rn(llr, __fsub_rn(1.f, p)), __fmul_rn(a.punct_val, p));
  llr = __fadd_rn(__fmul_rn(llr, __fsub_rn(1.f, s)), __fmul_rn(a.neg_clip_llr, s));
  if (a.fold) llr = __fmul_rn(llr, __fsub_rn(1.f, __fmul_rn(2.f, b)));
  return llr;
}

// noise, bits, out [R][B] and sigma [B], row-major; Q = ceil(B / 4) threads
// per row.  kVec: B % 4 == 0 and every pointer 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    awgn_llr_kernel(const float* __restrict__ noise, const float* __restrict__ sigma,
                    const float* __restrict__ bits, float* __restrict__ out, int R,
                    int B, int Q, Args a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)R * Q) return;
  const int r = (int)(t / Q);
  const int c = (int)(t - (long long)r * Q) * 4;
  const float p = (r >= a.p_lo && r < a.p_hi) ? 1.f : 0.f;
  const float s = (r >= a.s_lo && r < a.s_hi) ? 1.f : 0.f;
  const bool has_bits = bits != nullptr;
  const size_t off = (size_t)r * B + c;
  float n[4], sg[4], b[4] = {0.f, 0.f, 0.f, 0.f};
  if (kVec) {
    const float4 nv = *reinterpret_cast<const float4*>(noise + off);
    const float4 sv = *reinterpret_cast<const float4*>(sigma + c);
    n[0] = nv.x, n[1] = nv.y, n[2] = nv.z, n[3] = nv.w;
    sg[0] = sv.x, sg[1] = sv.y, sg[2] = sv.z, sg[3] = sv.w;
    if (has_bits) {
      const float4 bv = *reinterpret_cast<const float4*>(bits + off);
      b[0] = bv.x, b[1] = bv.y, b[2] = bv.z, b[3] = bv.w;
    }
    float4 o;
    o.x = llr_of(n[0], sg[0], b[0], has_bits, p, s, a);
    o.y = llr_of(n[1], sg[1], b[1], has_bits, p, s, a);
    o.z = llr_of(n[2], sg[2], b[2], has_bits, p, s, a);
    o.w = llr_of(n[3], sg[3], b[3], has_bits, p, s, a);
    *reinterpret_cast<float4*>(out + off) = o;
  } else {
    const int m = min(4, B - c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < m) {
        n[k] = noise[off + k];
        sg[k] = sigma[c + k];
        if (has_bits) b[k] = bits[off + k];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < m) out[off + k] = llr_of(n[k], sg[k], b[k], has_bits, p, s, a);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// noise, bits (nullptr: the all-zero word), out float [R][B], sigma float
// [B]; the row ranges 0-indexed and half-open (lo == hi: none).  Returns
// cudaGetLastError() after the launch (0 = launched), -1 for a fold
// without bits.
extern "C" int awgn_llr_launch(const void* noise, const void* sigma, const void* bits,
                               void* out, int R, int B, int quant, float step,
                               float clip, float punct_val, int p_lo, int p_hi,
                               int s_lo, int s_hi, float neg_clip_llr, int fold,
                               void* stream) {
  if (fold && bits == nullptr) return -1;
  if (R <= 0 || B <= 0) return 0;
  const Args a{quant, step, clip, punct_val, neg_clip_llr, p_lo, p_hi, s_lo, s_hi, fold};
  const int Q = (B + 3) / 4;
  const long long n = (long long)R * Q;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const bool vec = B % 4 == 0 && aligned16(noise) && aligned16(sigma) && aligned16(out) &&
                   (bits == nullptr || aligned16(bits));
  const float* nz = static_cast<const float*>(noise);
  const float* sg = static_cast<const float*>(sigma);
  const float* bt = static_cast<const float*>(bits);
  float* o = static_cast<float*>(out);
  if (vec)
    awgn_llr_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(nz, sg, bt, o, R,
                                                                          B, Q, a);
  else
    awgn_llr_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(nz, sg, bt, o, R,
                                                                           B, Q, a);
  return (int)cudaGetLastError();
}
