"""Command-line entry points (`python -m yt8m_tpu_torch.cli.<name>`)."""
