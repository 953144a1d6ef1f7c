"""Convert a JAX trainer's orbax checkpoint into a step of the PyTorch port.

Runs where JAX and orbax are installed (the PyTorch package imports
neither). It reads one step of the JAX run's train_dir with orbax, and
writes it with yt8m_tpu_torch.convert.write_step_from_jax as
<train_dir>/<step>/ in the port's layout (model.pt, ema.pt when the run
kept an EMA, optimizer.pt for Adam, step.json last), beside a copy of the
run's model_flags.json:

    python scripts/convert_jax_checkpoint.py --jax_train_dir=RUN \
        --train_dir=PORT_RUN [--step=N]

The port's cli.eval and cli.inference then serve PORT_RUN; with Adam's
state converted, `python -m yt8m_tpu_torch.cli.train --train_dir=PORT_RUN
...` resumes the run (pass --adam_mu_dtype=bfloat16 when the JAX run used
it; the script prints what it converted). Other optimizers' state is not
converted, and the port's trainer refuses to resume from such a step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_orbax_step(jax_train_dir: str, step=None):
    """(step, tree): a step of a JAX run (the latest by default) as orbax
    restores it without a target, every leaf a numpy array."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(jax_train_dir))
    try:
        step = mgr.latest_step() if step is None else int(step)
        if step is None:
            raise SystemExit(f"no orbax checkpoint in {jax_train_dir}")
        restored = mgr.restore(step)
    finally:
        mgr.close()
    return step, jax.tree_util.tree_map(np.asarray, dict(restored))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--jax_train_dir", required=True,
                        help="the JAX run: orbax steps and model_flags.json")
    parser.add_argument("--train_dir", required=True,
                        help="the port's run directory to write")
    parser.add_argument("--step", type=int, default=None,
                        help="the step to convert (default: the latest)")
    args = parser.parse_args(argv)

    from yt8m_tpu_torch.convert import FLAGS_FILE, write_step_from_jax

    with open(os.path.join(args.jax_train_dir, FLAGS_FILE)) as f:
        flags = json.load(f)
    step, restored = read_orbax_step(args.jax_train_dir, args.step)
    done = write_step_from_jax(args.train_dir, restored, flags, step)
    if done["optimizer"] is None:
        note = ("weights only: the optimizer's state has no port "
                "equivalent here; serve the step with cli.eval or "
                "cli.inference")
    else:
        note = (f"Adam's state converted: resume with cli.train "
                f"--adam_mu_dtype={done['adam_mu_dtype']}")
    print(f"wrote {done['path']} (model {flags['model']}, EMA "
          f"{'kept' if done['ema'] else 'none'}); {note}")
    return done


if __name__ == "__main__":
    main()
