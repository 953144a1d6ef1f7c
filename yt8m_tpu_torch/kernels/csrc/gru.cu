// GRU recurrence serving kernel for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/gru.py :: gru_recurrence. Given the input
// projections xg [F, B, 2H] and xc [F, B, H] (bf16, computed outside),
// every step runs the TF1 GRUCell of gru_step.cuh (r and u from the gate
// product, the candidate from bf16(r * h), the carry frozen past
// num_frames) and writes bf16(h); orig_t = F-1-t under `reverse` (xg and
// xc come flipped in time).
//
// What bounds it: per layer at B=512, F=300, H=1024 the products are
// 2 F B H 3H = 0.97 TFLOP (0.98 ms at the bf16 peak) against ~1.26 GB of
// xg, xc and outputs (0.38 ms at 3.35 TB/s): the tensor-core rate. Why
// two launches a step (the candidate product needs r over all H units,
// which the gate product makes) and the blocks' shape: gru_step.cuh.

#include "gru_step.cuh"

// xg [F, B, 2H], xc [F, B, H] bf16; whg [H, 2H], whc [H, H] bf16; bg
// [2H], bc [H] f32; h0 [B, H] bf16 (the first step's product operand); h
// [B, H] f32, the initial state on entry (zeros for a sequence) and the
// final state on return; u [B, H] f32 and rh [B, H] bf16 scratch; out
// [F, B, H] bf16. Launches 2F step kernels on `stream`.
extern "C" int yt8m_gru_recurrence(const void* xg, const void* xc, const void* num_frames,
                                   const void* whg, const void* whc, const void* bg,
                                   const void* bc, const void* h0, void* h, void* u, void* rh,
                                   void* out, int F, int B, int H, int reverse, void* stream) {
  return gru_step::run_forward<false>(xg, xc, num_frames, whg, whc, bg, bc, h0, h, u, rh, out,
                                      nullptr, nullptr, F, B, H, reverse, stream);
}
