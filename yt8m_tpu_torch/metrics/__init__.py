"""Eval metrics (GAP@20, Hit@1, PERR, mAP): numpy copies of the JAX
package's metrics/."""

from yt8m_tpu_torch.metrics.average_precision import (
    AveragePrecisionCalculator,
    ap_at_n,
)
from yt8m_tpu_torch.metrics.eval_metrics import (
    EvaluationMetrics,
    calculate_gap,
    calculate_hit_at_one,
    calculate_precision_at_equal_recall_rate,
)
from yt8m_tpu_torch.metrics.mean_average_precision import (
    MeanAveragePrecisionCalculator,
)
