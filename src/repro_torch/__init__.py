"""PyTorch/CUDA port of the mixed-precision RCLL SPH package (``repro``).

The layout mirrors ``src/repro``: ``repro_torch.core`` holds the plain
tensor code (domain, cells, RCLL state, solver, cases, facade) and
``repro_torch.kernels`` the hand-written CUDA kernels with their plain
PyTorch versions. The package imports ``torch`` and ``numpy`` only.

Entry points run on CUDA unless the caller passes ``device="cpu"``; a
missing GPU raises instead of falling back.
"""
