"""Compare the trainable recurrences of this checkout with another
checkout's, on the card, bit for bit, on the same inputs.

    python -m yt8m_tpu_torch.kernels.ab_compare --other DIR [--out DIR]

DIR is the root of another checkout (e.g. a `git archive` of a parent
commit unpacked under build/). Each checkout runs in its own process, with
its own package and kernel build: the trainable LSTM's and GRU's forward
(outputs, final state, residuals) and backward (dZ; dA_g and dA_c) at the
training shape (B=256, F=300, H=1024, num_frames uniform in 1..F with F,
0 and 1 planted), both directions, on inputs made from a seed. Both
backwards take the residuals of this checkout's forward. Printed for each
tensor: the number of values that differ, of how many, and the largest
difference; the residuals on the live (step, row) pairs only (a kernel
may write anything at a frozen step: every use there is masked).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

F, B, H = 300, 256, 1024
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _inputs(torch, kind, seed):
    g = torch.Generator().manual_seed(seed)
    nf = torch.randint(1, F + 1, (B,), generator=g, dtype=torch.int32)
    nf[:3] = torch.tensor([F, 0, 1], dtype=torch.int32)
    if kind == "lstm":
        ts = [(0.5 * torch.randn(F, B, 4 * H, generator=g)).to(torch.bfloat16),
              nf,
              (torch.randn(H, 4 * H, generator=g) * H ** -0.5).to(
                  torch.bfloat16),
              0.1 * torch.randn(4 * H, generator=g)]
    else:
        ts = [(0.5 * torch.randn(F, B, 2 * H, generator=g)).to(torch.bfloat16),
              (0.5 * torch.randn(F, B, H, generator=g)).to(torch.bfloat16),
              nf,
              (torch.randn(H, 2 * H, generator=g) * H ** -0.5).to(
                  torch.bfloat16),
              (torch.randn(H, H, generator=g) * H ** -0.5).to(torch.bfloat16),
              1.0 + 0.1 * torch.randn(2 * H, generator=g),
              0.1 * torch.randn(H, generator=g)]
    cot = [torch.randn(F, B, H, generator=g), torch.randn(B, H, generator=g),
           torch.randn(B, H, generator=g)]
    return [t.cuda() for t in ts], [t.cuda() for t in cot]


def run(out_path, residuals_path=None):
    """The package on sys.path: forward and backward of both recurrences,
    both directions, saved to out_path. The backwards take the residuals
    saved at residuals_path where given."""
    import torch

    from yt8m_tpu_torch.kernels import gru_train as tgt
    from yt8m_tpu_torch.kernels import lstm_train as tlt

    given = torch.load(residuals_path) if residuals_path else {}

    def shared(key, t):
        return given[key].cuda() if key in given else t

    res = {}
    for rev in (False, True):
        args, cot = _inputs(torch, "lstm", 1 + rev)
        key = f"lstm {rev}"
        outs, gates, cs, c, h = tlt.lstm_train_forward(*args, rev)
        res.update({f"{key} nf": args[1], f"{key} outs": outs,
                    f"{key} gates": gates, f"{key} cs": cs, f"{key} c": c,
                    f"{key} h": h})
        res[f"{key} dz"] = tlt.lstm_train_backward(
            cot[0], cot[1], cot[2], shared(f"{key} gates", gates),
            shared(f"{key} cs", cs), args[1], args[2], rev)
        args, cot = _inputs(torch, "gru", 3 + rev)
        key = f"gru {rev}"
        outs, gates, cand, h = tgt.gru_train_forward(*args, rev)
        res.update({f"{key} nf": args[2], f"{key} outs": outs,
                    f"{key} gates": gates, f"{key} cand": cand,
                    f"{key} h": h})
        res[f"{key} dag"], res[f"{key} dac"] = tgt.gru_train_backward(
            cot[0], cot[2], shared(f"{key} gates", gates),
            shared(f"{key} cand", cand), shared(f"{key} outs", outs),
            args[2], args[3], args[4], rev)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in res.items()}, out_path)


def compare(torch, a, b):
    """Lines: each tensor's differing values against the other run's, the
    residuals on the live (step, row) pairs only."""
    lines = []
    for key in a:
        kind, rev, name = key.split()
        if name == "nf":
            continue
        x, y = a[key], b[key]
        if name in ("gates", "cs", "cand"):
            t = torch.arange(F)[:, None]
            orig = (F - 1 - t) if rev == "True" else t
            live = a[f"{kind} {rev} nf"].to(torch.int64)[None, :] > orig
            x, y = x[live], y[live]
        n = int((x != y).sum())
        diff = (x.float() - y.float()).abs().max().item()
        lines.append(f"{kind} reverse={rev} {name}: {n} of {x.numel()} values "
                     f"differ, max|diff| {diff:.3e}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "ab"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_compare needs a CUDA device")
    os.makedirs(args.out, exist_ok=True)
    mine = os.path.join(args.out, "this.pt")
    other = os.path.join(args.out, "other.pt")
    # Each checkout's package first on the path, in its own process; this
    # file's run() loaded by path (the other checkout need not have it).
    code = ("import sys, importlib.util as u; sys.path.insert(0, sys.argv[1]);"
            " s = u.spec_from_file_location('ab_compare', sys.argv[2]);"
            " m = u.module_from_spec(s); s.loader.exec_module(m);"
            " m.run(*sys.argv[3:])")
    for root, extra in ((ROOT, [mine]),
                        (os.path.abspath(args.other), [other, mine])):
        subprocess.run([sys.executable, "-c", code, root,
                        os.path.abspath(__file__), *extra], cwd=root,
                       check=True)
    for line in compare(torch, torch.load(mine), torch.load(other)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
