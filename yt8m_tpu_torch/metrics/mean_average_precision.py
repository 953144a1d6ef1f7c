"""Per-class mean average precision.

Reference: mean_average_precision_calculator.py ::
MeanAveragePrecisionCalculator — one AveragePrecisionCalculator per class;
``peek_map_at_n`` returns the list of per-class APs (the caller averages).

A numpy copy of the JAX package's metrics/mean_average_precision.py, so
that the port imports nothing of that package.
"""

from __future__ import annotations

from typing import List, Optional

from yt8m_tpu_torch.metrics.average_precision import AveragePrecisionCalculator


class MeanAveragePrecisionCalculator:
    def __init__(self, num_class: int, top_n: Optional[int] = None):
        if num_class < 1:
            raise ValueError("num_class must be a positive integer.")
        self._ap_calculators = [
            AveragePrecisionCalculator(top_n) for _ in range(num_class)
        ]
        self._num_class = num_class

    def accumulate(self, predictions, actuals, num_positives=None) -> None:
        """predictions/actuals: per-class lists of sparse value lists."""
        if num_positives is None:
            num_positives = [None] * self._num_class
        for c, calc in enumerate(self._ap_calculators):
            calc.accumulate(predictions[c], actuals[c], num_positives[c])

    def clear(self) -> None:
        for calc in self._ap_calculators:
            calc.clear()

    def is_empty(self) -> bool:
        return all(c.heap_size == 0 for c in self._ap_calculators)

    def peek_map_at_n(self) -> List[float]:
        return [c.peek_ap_at_n() for c in self._ap_calculators]
