"""chip_smoke.py's multi-GPU training steps on four cards, one rank a card
over NCCL.

    python3 scripts/tp_four_cards.py    # on a host with four cards

Phase 10 (a) (chip_smoke.py :: parallel_one_rank_a_card): the fused
flagship at global B=256, 3 Adam steps each data-parallel, FSDP and
tensor-parallel at (2, 2) and (1, 4) on every visible card, then the same
at two ranks (data-parallel, FSDP, TP at (1, 2)): each rank's step ms,
peak GiB and NCCL's device ms in one step. Then (e) (tp_workflow):
cli.train --model_parallel=2 at two ranks over NCCL and cli.eval at one.
On fewer than four cards it stops after the first part.
"""
import os
import shutil
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    from yt8m_tpu_torch.data.synthetic import write_dataset
    from yt8m_tpu_torch.kernels import _build
    from yt8m_tpu_torch.parallel.distributed import launch

    print(cs.nvidia_smi_line(), flush=True)
    res = _build.build()
    _build.library()
    print("build", res.seconds if res.built else "cached", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cs.parallel_one_rank_a_card(torch, dev)
    print("four cards", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    if torch.cuda.device_count() < 4:
        sys.exit(0)
    ranks = launch(cs.parallel_rank, (cs.PARALLEL_STEPS, "cuda"), nprocs=2,
                   device="cuda", timeout_s=cs.PARALLEL_DEADLINE_S)
    for r in ranks:
        for mode, _, _ in cs.parallel_modes(2):
            m = r[mode]
            cs.say("parallel", f"(a) rank {r['rank']}/2 {mode} grid "
                               f"{m['grid']}: step ms {m['step_ms']:.3f} of "
                               f"{[round(t, 3) for t in m['times_ms']]}, "
                               f"peak {m['peak_gib']:.3f} GiB, NCCL "
                               f"{m['comm_ms']} of {m['device_ms']} device "
                               f"ms, sharded {m['sharded']}, losses "
                               f"{[round(x, 4) for x in m['losses']]}")
    print("two cards", time.perf_counter() - t0, flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="tp4_", dir=os.path.join(ROOT, "build"))
    try:
        data = os.path.join(work, "parallel_data")
        write_dataset(data, "train", num_shards=4,
                      videos_per_shard=cs.PARALLEL_TRAIN_VIDEOS // 4,
                      frame_level=True, num_classes=cs.CLASSES, seed=11)
        write_dataset(data, "validate", num_shards=2,
                      videos_per_shard=cs.PARALLEL_EVAL_VIDEOS // 2,
                      frame_level=True, num_classes=cs.CLASSES, seed=12)
        cs.tp_workflow(torch, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("ok", flush=True)
