"""Scalar summaries (reference: TensorBoard summaries via utils.py ::
MakeSummary / AddGlobalStepSummary / AddEpochSummary).

A copy of the JAX package's utils/summary.py without its TensorFlow
branch: one JSON object a line in `<logdir>/events.jsonl`, the step, the
wall time and the scalars under the reference's names
("GlobalStep/Loss", "Epoch/GAP", ...).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class SummaryWriter:
    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(
            os.path.join(logdir, "events.jsonl"), "a", buffering=1
        )

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")

    def add_global_step_summary(
        self, step: int, summary_name_value: Dict[str, float]
    ) -> None:
        self.scalars(step, {f"GlobalStep/{k}": v
                            for k, v in summary_name_value.items()})

    def add_epoch_summary(
        self, step: int, summary_name_value: Dict[str, float]
    ) -> None:
        self.scalars(step, {f"Epoch/{k}": v
                            for k, v in summary_name_value.items()})

    def close(self) -> None:
        self._jsonl.close()
