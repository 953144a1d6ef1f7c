"""Hand-written CUDA kernels of the serving path, with their plain
PyTorch versions and launch counters.

Each wrapper takes its plain version for a tensor on the CPU (the tests'
path) and launches its kernel for a tensor on the card, or raises; there
is no fallback from the card to the plain version. `<wrapper>.launches`
counts the kernel's launches in this process. The serving wrappers are
registered as custom operators in `ops.py`, which the models call and
`torch.export` traces.
"""
