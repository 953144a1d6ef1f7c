"""Serving: the top-k predict step and the inference loop."""
