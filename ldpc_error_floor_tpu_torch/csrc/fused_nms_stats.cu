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
// The loop itself, what its design does about that and how it rounds, is
// csrc/fused_nms_kernel.cuh (shared with the training forward B4).  It
// launches on the caller's stream, allocates nothing and does not
// synchronise.

#include "fused_nms_kernel.cuh"

// mode: 0 fixed T, 1 genie early stop, 2 deploy; sp: the SP check update.
// Stats modes write app [N*z][B], err uint8 [T][B], nerr int [T][B] (iters
// and fail unused); deploy writes app, err uint8 [B], nerr int [B], iters
// int [B], fail uint8 [B].  `smem` is the dynamic shared memory of one
// block (ops/fused_decoder.py::_smem_bytes); qinv = 1/qstep, exactly (a
// power of two).  Returns cudaGetLastError() after the launch (0 =
// launched), or -1 for an unknown mode.
extern "C" int fused_nms_launch(
    const void* llr, const void* w_cn, const void* w_ucn, const void* w_vn,
    const void* tab, void* app, void* err, void* nerr, void* iters,
    void* fail, int N, int M, int z, int E, int T, int B, int G, int threads,
    int smem, int target, int dec_type, float qstep, float qinv, float qclip,
    float clip_llr, int cn_mode, int ucn, int vn_mode, int offset_mode,
    int dim_cn, int dim_vn, int mode, int sp, void* stream) {
  const Msg ms{dec_type, qinv, qstep, qclip, clip_llr};
#define FUSED_NMS_LAUNCH(MODE, SP)                                            \
  launch<MODE, SP>(llr, w_cn, w_ucn, w_vn, tab, app, err, nerr, iters, fail, \
                   nullptr, nullptr, N, M, z, E, T, B, G, 1, threads, smem,   \
                   target, 0, ms, cn_mode, ucn, vn_mode, offset_mode, dim_cn, \
                   dim_vn, (cudaStream_t)stream)
  switch (mode * 2 + (sp ? 1 : 0)) {
    case 0: return FUSED_NMS_LAUNCH(kFixed, false);
    case 1: return FUSED_NMS_LAUNCH(kFixed, true);
    case 2: return FUSED_NMS_LAUNCH(kEarlyStop, false);
    case 3: return FUSED_NMS_LAUNCH(kEarlyStop, true);
    case 4: return FUSED_NMS_LAUNCH(kDeploy, false);
    case 5: return FUSED_NMS_LAUNCH(kDeploy, true);
  }
#undef FUSED_NMS_LAUNCH
  return -1;
}
