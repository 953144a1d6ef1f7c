"""Evaluation loop of the port."""
