"""PyTorch/CUDA port of ``icl_speech_text_llm_tpu`` for NVIDIA Hopper GPUs.

Same module names and parameter-tree layout as the JAX package, which stays
in the repository as the reference the port is tested against. Plain tensor
code is PyTorch; every Pallas kernel the main path runs is a hand-written
CUDA kernel under ``csrc/`` (built at first use by ``kernels.py``), with a
plain PyTorch version beside it that runs on CPU tensors.

This package imports ``torch`` and never ``jax``. It reuses the JAX
package's framework-free modules that import without jax (``registry``,
``utils.tokenization``, ``utils.native``) and carries its own copies of the
data and evaluation modules, whose JAX-package versions pull in jax or
pandas at import.
"""

__version__ = "0.1.0"
