"""Feature-name registry (reference: utils.py :: GetListOfFeatureNamesAndSizes).

The reference selects input features by parallel comma-separated flags, e.g.
  --feature_names="rgb,audio" --feature_sizes="1024,128"   (frame level)
  --feature_names="mean_rgb,mean_audio" --feature_sizes="1024,128"  (video)
"""

from __future__ import annotations

from typing import List, Tuple

MAX_FRAMES = 300
NUM_CLASSES = 4716


def get_feature_names_and_sizes(
    feature_names: str, feature_sizes: str
) -> Tuple[List[str], List[int]]:
    """Parse the flag strings; errors mirror the reference's assertion."""
    names = [n.strip() for n in feature_names.split(",") if n.strip()]
    sizes = [int(s) for s in feature_sizes.split(",") if s.strip()]
    if len(names) != len(sizes):
        raise ValueError(
            "length of the feature names (={}) != length of feature sizes"
            " (={})".format(len(names), len(sizes))
        )
    return names, sizes
