"""Ensembles: prediction dumps averaged and fitted, bagging, boosting,
distillation data and checkpoint ensembles (copies of the JAX package's
ensemble/ modules over the port)."""
