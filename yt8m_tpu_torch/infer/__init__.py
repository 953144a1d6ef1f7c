"""Serving: the top-k predict step, the inference loop and the serving
export."""
