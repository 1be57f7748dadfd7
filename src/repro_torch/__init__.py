"""PyTorch/CUDA port of the ``repro`` package: serving
(``launch/serve.py``) and training (``launch/train.py`` over the Swan
``TrainSession``) of the dense decoder family.

It mirrors the module names of ``src/repro/`` so that each module's
counterpart is easy to find. It imports ``torch``, numpy and the standard
library only: never ``jax`` and never a module of ``repro``. Where it needs
a framework-free module of the JAX package it keeps its own copy.

Entry points take ``device=`` and default to ``"cuda"``. They raise when
CUDA is missing and never fall back to the CPU on their own; the tests pass
``device="cpu"``, where every kernel wrapper runs its plain PyTorch version.
"""
