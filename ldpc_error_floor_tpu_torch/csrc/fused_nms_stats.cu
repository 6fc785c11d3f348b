// Fused neural min-sum / sum-product decode: fixed T, genie early stop and
// syndrome stop ("deploy").
//
// Replaces ldpc_error_floor_tpu/ops/pallas_decoder.py::FusedNMSKernel._kernel
// in all its modes:
//   kFixed     mode='stats', fixed T                      (MS, QMS, MS_RAW; SP)
//   kEarlyStop mode='stats', early_stop=True (:487-490, :747-757)
//   kDeploy    mode='deploy' (:692-746; host side decode_deploy :987-1008)
// and, as the template flag kSP, its sum-product check update (:567-596).
// The plain PyTorch versions are ops/fused_decoder.py::decode_stats_plain
// and decode_deploy_plain, ports of the scan body of
// ldpc_error_floor_tpu/models/nms.py; under QMS the kernel and they agree
// bit for bit (SP to a tolerance: tanhf/atanhf are not PyTorch's).
//
// What bounds it on an H100: on-chip work, not device memory.  A codeword
// moves ~4.7 KB through device memory (LLRs in, APP out, T flags and counts)
// but every iteration touches each of its E*z edge slots about twice in
// shared memory and spends ~16 simple f32 operations on each (adds,
// compares, selects; no FMA), so the operation count and shared-memory
// traffic are ~20x the device-memory time at 3.35 TB/s.  SP adds a tanhf
// and an atanhf per edge slot, which run on the special-function units.
//
// Each mode has a second instance (kExtra 1) that counts against given
// codeword bits, and the fixed T a third (kExtra 2) that also writes the
// per-iteration syndrome flags, as the scan decoder does with labels and
// track_syndrome; the zero word keeps its own instance.  The loop itself, what its design does about
// that and how it rounds, is csrc/fused_nms_kernel.cuh (shared with the
// training forward B4).  It
// launches on the caller's stream, allocates nothing and does not
// synchronise.

#include "fused_nms_kernel.cuh"

// mode: 0 fixed T, 1 genie early stop, 2 deploy; sp: the SP check update;
// code: the code-domain state (QMS only; u, uinv, clipc, qshift its grid in
// units of u, see Msg).  Stats modes write app [N*z][B],
// err uint8 [T][B], nerr int [T][B] (iters and fail unused); deploy writes
// app, err uint8 [B], nerr int [B], iters int [B], fail uint8 [B].  `lab`
// (uint8 [target*z][B], 0 or 1) is the codeword the errors count against
// and `synd` (uint8 [T][B], fixed T only) receives the per-iteration
// syndrome flags: `synd` not null takes the instance with kExtra 2, else
// `lab` not null the one with kExtra 1, both null the zero word's.  `smem` is the dynamic shared memory of one
// block (ops/fused_decoder.py::_smem_bytes); qinv = 1/qstep, exactly (a
// power of two).  The code state's early stop (`launch_word_stop`) also
// takes `lut` (the output-byte tables of every iteration staged) and
// `engage` (count its lane-steps and words); the others ignore both.
// `words` is B, except for a host read of K batches through the code
// state's early stop: `llr` [K][N*z][B], `words` K*B, its genie counters
// added to `totals` (int64 [3]) and no rows or APP written; every other
// launch takes a null `totals`.
// Returns cudaGetLastError() after the launch (0 = launched), -1 for an
// unknown instance, -2 for a shared-memory size that is not the layout's,
// -3 for `words` or `totals` that the launch does not take.
#define FUSED_NMS_INSTANCES(X)                                                \
  X(0, kFixed, false, false, 0)                                               \
  X(1, kFixed, true, false, 0)                                                \
  X(2, kFixed, false, true, 0)                                                \
  X(3, kEarlyStop, false, false, 0)                                           \
  X(4, kEarlyStop, true, false, 0)                                            \
  X(5, kEarlyStop, false, true, 0)                                            \
  X(6, kDeploy, false, false, 0)                                              \
  X(7, kDeploy, true, false, 0)                                               \
  X(8, kDeploy, false, true, 0)                                               \
  X(9, kFixed, false, false, 1)                                               \
  X(10, kFixed, true, false, 1)                                               \
  X(11, kFixed, false, true, 1)                                               \
  X(12, kEarlyStop, false, false, 1)                                          \
  X(13, kEarlyStop, true, false, 1)                                           \
  X(14, kEarlyStop, false, true, 1)                                           \
  X(15, kDeploy, false, false, 1)                                             \
  X(16, kDeploy, true, false, 1)                                              \
  X(17, kDeploy, false, true, 1)                                              \
  X(18, kFixed, false, false, 2)                                              \
  X(19, kFixed, true, false, 2)                                               \
  X(20, kFixed, false, true, 2)

static int instance(int mode, int sp, int code, int extra) {
  if (mode < 0 || mode > 2 || (sp && code) || (extra == 2 && mode != 0)) return -1;
  return extra * 9 + mode * 3 + (sp ? 1 : (code ? 2 : 0));
}

// The early stop of the code state is its own kernel, the genie stop per
// word (fused_nms_kernel_word_stop); every other instance is the loop's.
template <int kMode, bool kSP, bool kCode, int kExtra>
static int launch_instance(const void* llr, const void* w_cn, const void* w_ucn,
                           const void* w_vn, const void* tab, void* app, void* err,
                           void* nerr, void* iters, void* fail, int N, int M, int z,
                           int E, int T, int B, int G, int threads, int smem,
                           int target, Msg ms, int cn_mode, int ucn, int vn_mode,
                           int offset_mode, int dim_cn, int dim_vn, int lut, int engage,
                           int words, void* totals, cudaStream_t stream, const void* lab,
                           void* synd) {
  if constexpr (kMode == kEarlyStop && kCode)
    return launch_word_stop<kExtra>(llr, w_cn, w_ucn, w_vn, tab, app, err, nerr, totals,
                                    N, M, z, E, T, B, words, G, threads, smem, target,
                                    ms, cn_mode, ucn, vn_mode, offset_mode, dim_cn,
                                    dim_vn, lut, engage, stream, lab);
  else if (words != B || totals != nullptr)
    return -3;
  else
    return launch<kMode, kSP, kCode, kSPChunks, kExtra>(
        llr, w_cn, w_ucn, w_vn, tab, app, err, nerr, iters, fail, nullptr, nullptr, N,
        M, z, E, T, B, G, 1, threads, smem, target, 0, ms, cn_mode, ucn, vn_mode,
        offset_mode, dim_cn, dim_vn, stream, lab, synd);
}

extern "C" int fused_nms_launch(
    const void* llr, const void* w_cn, const void* w_ucn, const void* w_vn,
    const void* tab, void* app, void* err, void* nerr, void* iters,
    void* fail, const void* lab, void* synd, int N, int M, int z, int E,
    int T, int B, int G, int threads, int smem, int target, int dec_type,
    float qstep, float qinv, float qclip, float clip_llr, float u, float uinv,
    int clipc, int qshift, int cn_mode, int ucn, int vn_mode, int offset_mode,
    int dim_cn, int dim_vn, int mode, int sp, int code, int lut, int engage,
    int words, void* totals, void* stream) {
  const Msg ms{dec_type, qinv, qstep, qclip, clip_llr, u, uinv, clipc, qshift};
  switch (instance(mode, sp, code, synd != nullptr ? 2 : (lab != nullptr ? 1 : 0))) {
#define FUSED_NMS_LAUNCH(ID, MODE, SP, CODE, EXTRA)                           \
  case ID:                                                                    \
    return launch_instance<MODE, SP, CODE, EXTRA>(                            \
        llr, w_cn, w_ucn, w_vn, tab, app, err, nerr, iters, fail, N, M, z, E, \
        T, B, G, threads, smem, target, ms, cn_mode, ucn, vn_mode,            \
        offset_mode, dim_cn, dim_vn, lut, engage, words, totals,              \
        (cudaStream_t)stream, lab, synd);
    FUSED_NMS_INSTANCES(FUSED_NMS_LAUNCH)
#undef FUSED_NMS_LAUNCH
  }
  return -1;
}

// Blocks of one zero-word instance that an SM of the current card holds at
// `threads` threads and `smem` bytes of dynamic shared memory (0: none or a
// failed query, -1: an unknown instance).
extern "C" int fused_nms_resident_blocks(int mode, int sp, int code,
                                         int threads, int smem) {
  switch (instance(mode, sp, code, 0)) {
#define FUSED_NMS_RESIDENT(ID, MODE, SP, CODE, EXTRA)                         \
  case ID:                                                                    \
    return resident_blocks<MODE, SP, CODE>(threads, smem);
    FUSED_NMS_INSTANCES(FUSED_NMS_RESIDENT)
#undef FUSED_NMS_RESIDENT
  }
  return -1;
}

// The early stop's engagement pair on the current card (both instances of
// fused_nms_kernel_word_stop add to it under a profiler): out[0] its
// lane-steps, out[1] its words; `reset` sets it back to 0 after the read.
// Synchronises with the card.  Returns the CUDA error (0 = read).
extern "C" int fused_nms_word_stop_counters(long long* out, int reset) {
  unsigned long long pair[2];
  cudaError_t st = cudaMemcpyFromSymbol(pair, g_word_stop_engage, sizeof pair);
  if (st != cudaSuccess) return (int)st;
  out[0] = (long long)pair[0];
  out[1] = (long long)pair[1];
  if (reset) {
    pair[0] = pair[1] = 0;
    st = cudaMemcpyToSymbol(g_word_stop_engage, pair, sizeof pair);
  }
  return (int)st;
}
