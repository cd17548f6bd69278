"""PyTorch / CUDA port of the ASkotch KRR system (the JAX package ``repro``
is the reference it is held against).

The layout mirrors ``repro``: ``core`` (problem, operators, Nystrom,
ASkotch, solver API), ``kernels`` (dispatch, plain PyTorch versions, and the
hand-written CUDA kernels built from ``csrc/``), ``data``, ``obs`` and
``launch``.  Kernel dispatch goes by the tensor's device: a CPU tensor runs
the plain PyTorch version, a CUDA tensor launches the CUDA kernel.
"""
