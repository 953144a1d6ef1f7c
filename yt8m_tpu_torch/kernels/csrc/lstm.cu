// LSTM recurrence serving kernel for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/lstm.py :: lstm_recurrence. Given the input
// projection X' [F, B, 4H] (bf16, computed outside), every step runs the
// cell of lstm_step.cuh (TF gate order i, j, f, o, forget bias 1, the
// carry frozen past num_frames) and writes bf16(h); orig_t = F-1-t under
// `reverse` (X' comes flipped in time).
//
// What bounds it: per layer at B=512, F=300, H=1024 the products are
// 1.29 TFLOP (1.30 ms at the bf16 peak) against 1.57 GB of X' and
// outputs (0.47 ms at 3.35 TB/s): the tensor-core rate. The design (one
// launch per step, a block per 128 rows x 32 units of all four gates) is
// in lstm_step.cuh.

#include "lstm_step.cuh"

// xp [F, B, 4H] bf16; h0 [B, H] bf16 (the first step's h); c, h [B, H]
// f32, the initial state on entry (zeros for a sequence) and the final
// state on return; out [F, B, H] bf16. Launches F step kernels on
// `stream`.
extern "C" int yt8m_lstm_recurrence(const void* xp, const void* num_frames, const void* wh,
                                    const void* bias, const void* h0, void* c, void* h,
                                    void* out, int F, int B, int H, int reverse, void* stream) {
  return lstm_step::run_forward<false>(xp, num_frames, wh, bias, h0, c, h, out, nullptr,
                                       nullptr, F, B, H, reverse, stream);
}
