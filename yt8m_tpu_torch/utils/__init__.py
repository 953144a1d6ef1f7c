"""CLI helpers."""
