"""PyTorch/CUDA bidirectional BFS: the single-device dense search of
``bibfs_tpu`` and its batched search on an NVIDIA Hopper card.

The package keeps the JAX package's layout and function names so each
counterpart is easy to find (``graph/``, ``ops/``, ``solvers/``,
``cli/``). It imports ``torch`` and numpy only. Device entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; without a card
they raise instead of falling back to the CPU.

The four level kernels of a search and the batch-minor level of a batch
(``ops/minor_level.py``) are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use (``ops/_cuda.py``). On a CPU
tensor every kernel wrapper runs its plain torch version instead.
"""

__version__ = "0.1.0"
