"""Time variants of this checkout's CUDA sources on the card, to see what a
part of a kernel costs.

    python -m yt8m_tpu_torch.kernels.variants base ieee_div agg_f64
    python -m yt8m_tpu_torch.kernels.variants --kernels attention,topk \
        base attn_no_pass2_loads attn_ring4 topk_no_early_exit

Each name in VARIANTS is a copy of the package (and chip_smoke.py) under
build/var/<name> with textual edits to csrc/ sources: a part skipped or
done another way. `base` is the unedited copy. Each copy builds its own
kernels and runs, in its own process, ab_compare.py's `run_vlad_int8`
(`--kernels vlad,int8`, the default: netvlad_aggregate at B=512 with
float32 and uint8 frames, dbof_cluster_maxpool_int8 at B=2048) or
`run_attn_topk` (`--kernels attention,topk`: exact_topk at B=512 and
2048, k=20, and at B=512, k=64; attention_pool at B=512, F=300, D=1152,
H=8 with uint8 and float32 frames), each call timed by the profiler's
device time, median of 7 windows, the L2 flushed before each. Printed:
each call's time and its split by kernel, a line a variant. An edit that
no longer applies to the sources raises: the table describes this
checkout.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

from yt8m_tpu_torch.kernels import ab_compare

ROOT = ab_compare.ROOT

# name -> [(source under csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    # The correctly rounded divisions (div_by) back to IEEE divisions.
    "ieee_div": [("netvlad.cu",
                  "  const float q = __fmul_rn(a, rb);\n"
                  "  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);",
                  "  (void)rb;\n  return a / b;")],
    # The aggregation in 64-frame stages, two of them (the smem the
    # centers leave), or 16-frame stages, eight of them.
    "agg_f64": [("netvlad.cu", "constexpr int kAggFrames = 32;",
                 "constexpr int kAggFrames = 64;"),
                ("netvlad.cu", "constexpr int kAggStages = 4;",
                 "constexpr int kAggStages = 2;")],
    "agg_f16": [("netvlad.cu", "constexpr int kAggFrames = 32;",
                 "constexpr int kAggFrames = 16;"),
                ("netvlad.cu", "constexpr int kAggStages = 4;",
                 "constexpr int kAggStages = 8;")],
    # The assignment's expf as __expf.
    "fast_exp": [("netvlad.cu", "expf(__fsub_rn(acc[a], mx[h]))",
                  "__expf(__fsub_rn(acc[a], mx[h]))")],
    # The normalised pass without its stores (the divisions go with them).
    "no_store": [("netvlad.cu", "              if (k < K)\n"
                  "                *reinterpret_cast<float2*>(dst + 8 * j) =",
                  "              if (k < -1)\n"
                  "                *reinterpret_cast<float2*>(dst + 8 * j) =")],
    # The int8 kernel without its epilogue (the products still run).
    "int8_no_epilogue": [
        ("dbof_int8.cu", "      // Epilogue. Each column's sums",
         "      if (nk < 0) {\n      // Epilogue. Each column's sums"),
        ("dbof_int8.cu",
         "            if (n < K) out[static_cast<size_t>(b) * K + n] = "
         "fmaxf(y, 0.0f);\n          }\n        }\n      }\n",
         "            if (n < K) out[static_cast<size_t>(b) * K + n] = "
         "fmaxf(y, 0.0f);\n          }\n        }\n      }\n      }\n")],
    # Attention pooling: pass 2 without its loads from L2 (the stages it
    # reloads keep stale rows: the time of the reads, not a result), and
    # a ring of 4 stages instead of up to 12 (videos past 64 frames read
    # twice; pass 1 on 4 warps).
    "attn_no_pass2_loads": [
        ("attention_pool.cu",
         "          bar_expect(&full[slot], p.stage_bytes);\n",
         "          if (j >= p1) {\n            bar_arrive(&full[slot]);\n"
         "            continue;\n          }\n"
         "          bar_expect(&full[slot], p.stage_bytes);\n")],
    "attn_ring4": [("attention_pool.cu", "constexpr int kMaxStages = kWarps;",
                    "constexpr int kMaxStages = 4;")],
    # Attention pooling without pass 1's products (the chunk loop: the
    # dequantization, the fragments and the mma), or without pass 2's
    # (the groups' loads and products): what the rest of the walk costs.
    "attn_no_pass1_math": [("attention_pool.cu",
                            "for (int j = 0; j < D / kChunk; ++j) {",
                            "for (int j = 0; j < 0; ++j) {")],
    "attn_no_pass2_math": [("attention_pool.cu",
                            "        if (gi >= ngroups) break;\n"
                            "        const int col = kGroup * (warp + kWarps * gi) + 4 * g;\n"
                            "        float x0",
                            "        if (gi >= 0) break;\n"
                            "        const int col = kGroup * (warp + kWarps * gi) + 4 * g;\n"
                            "        float x0")],
    # Top-k that loads the row's keys and stops: the load's share.
    "topk_load_only": [("topk.cu", "  load_keys<V>(xr, keys, C, &best);\n",
                        "  load_keys<V>(xr, keys, C, &best);\n"
                        "  if (C > 0) return;\n")],
    # Top-k with every radix select running all four byte passes.
    "topk_no_early_exit": [("topk.cu", "if (s_count == *need) break;",
                            "if (false && s_count == *need) break;")],
}

# --kernels -> (ab_compare's run function, its cases)
RUNS = {
    "vlad,int8": ("run_vlad_int8", ab_compare.VLAD_CASES),
    "attention,topk": ("run_attn_topk", tuple(
        f"topk B={b} k={k}" for b, k in ab_compare.TOPK_CASES)
        + ab_compare.ATTN_CASES),
}


def make(name: str) -> str:
    """build/var/<name>: the package and chip_smoke.py with the variant's
    edits; returns its root."""
    dst = os.path.join(ROOT, "build", "var", name)
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    shutil.copytree(os.path.join(ROOT, "yt8m_tpu_torch"),
                    os.path.join(dst, "yt8m_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    csrc = os.path.join(dst, "yt8m_tpu_torch", "kernels", "csrc")
    for src, old, new in VARIANTS[name]:
        path = os.path.join(csrc, src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {src} has {text.count(old)} "
                             f"copies of the text to edit, not 1")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def _short(kernel: str) -> str:
    """A profiler kernel name without its namespace and parameters."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return name.replace("void ", "")[-48:]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="vlad,int8", choices=tuple(RUNS))
    ap.add_argument("names", nargs="*", choices=[[], *VARIANTS],
                    help="variants to run (default: all)")
    args = ap.parse_args(argv)
    names = args.names or list(VARIANTS)
    run, cases = RUNS[args.kernels]
    if not torch.cuda.is_available():
        raise SystemExit("variants needs a CUDA device")
    out = os.path.join(ROOT, "build", "var")
    results = {}
    for name in names:
        root = make(name)
        path = os.path.join(out, f"{name}.pt")
        ab_compare._in_checkout(root, run, path, "0")
        results[name] = torch.load(path)
    for name, r in results.items():
        for key in cases:
            split = sorted(r[f"{key} split"].items(), key=lambda kv: -kv[1])
            print(f"{name} {key}: {r[f'{key} ms']:.4f} ms = " + " + ".join(
                f"{v:.4f} {_short(n)}" for n, v in split),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
