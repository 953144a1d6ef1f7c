"""The f32 NetVLAD route on the card, kernel by kernel.

    python scripts/vlad_f32_split.py

netvlad_aggregate's f32 route (Wc's TF32 split copy) at B=512, F=300,
D=1152 with chip_smoke.py's inputs (K=256 with uint8 and with f32
frames, K=1024 with uint8 frames): max|route - plain| against the
card's bound 1e-5 * max|ref| + 1e-8, each's and the f32 graph's max
error against float64 (chip_smoke.py :: vlad_f64), the CUDA-event time
(chip_smoke.py :: time_ms, the L2 flushed) and the profiler's device
time by kernel (chip_smoke.py :: device_kernels). Needs a CUDA device.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from yt8m_tpu_torch.kernels.netvlad import (  # noqa: E402
    netvlad_aggregate,
    netvlad_aggregate_plain,
)
from yt8m_tpu_torch.kernels.tf32 import split_weights  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
gen = torch.Generator().manual_seed(2020)
for dt, k in ((torch.uint8, 256), (torch.float32, 256), (torch.uint8, 1024)):
    args = cs.vlad_inputs(torch, gen, 512, 300, 1152, k, dt, dev)
    args[2] = args[2].float()
    ws = split_weights(args[2])
    got = netvlad_aggregate(*args, ws)
    want = netvlad_aggregate_plain(*args)
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    w64 = cs.vlad_f64(torch, *args)
    print(dt, k, "err", err, "bound", 1e-5 * top + 1e-8,
          "route-f64", (got.double() - w64).abs().max().item(),
          "graph-f64", (want.double() - w64).abs().max().item(), flush=True)
    fn = lambda: netvlad_aggregate(*args, ws)  # noqa: E731
    ms = cs.time_ms(torch, fn, 10, flush)
    split = cs.device_kernels(torch, fn, "nv_")
    print(dt, k, "events", ms, "device", sum(split.values()) / 1e3, flush=True)
    for name, us in sorted(split.items(), key=lambda kv: -kv[1]):
        print("   ", round(us / 1e3, 4), name[:90], flush=True)
    del args, got, want, w64
    torch.cuda.empty_cache()
