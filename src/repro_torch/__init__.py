"""PyTorch/CUDA port of the REMIX reproduction (``src/repro`` is the JAX
reference).

The package mirrors ``repro`` module for module. It imports ``torch`` and
``numpy`` and nothing of JAX or of ``repro``. Entry points take a
``device`` argument that defaults to ``"cuda"`` and raise where CUDA is
absent unless the caller asks for ``"cpu"``; the two hot kernels (anchor
search, selector decode) are hand-written CUDA for Hopper under
``csrc/``, built with ``nvcc`` on first use.
"""
