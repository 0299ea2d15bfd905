"""PyTorch / CUDA port of the heart-failure ensemble framework.

A second package beside ``machine_learning_replications_tpu`` (the JAX
reference, which stays as it is). Module paths mirror the JAX package so a
reader finds each counterpart under the same name. The port imports
``torch`` and ``numpy`` only: never ``jax``, ``flax`` or any module of the
JAX package; what it needs from a jax-free module there is copied here.

Entry points take ``device=`` and default to CUDA. Without a card they
raise instead of moving to the CPU; the CPU tests pass ``device="cpu"``.
The one hand-written kernel (the histogram pass of the GBDT fits: the
fused depth-1 fit's stump histograms and the level-wise grower's node
histograms) lives in ``ops/csrc/histogram.cu`` and is built with ``nvcc``
on first use (``ops/cuda_histogram.py``).
"""

__version__ = "0.1.0"
