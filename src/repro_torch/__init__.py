"""PyTorch/CUDA port of the Chameleon TCN system (streaming sessions,
few-shot and continual enrollment, training) and of the reference's dense
LM serving path, for NVIDIA Hopper.

Mirrors ``repro``'s subpackage and module names so every module has an
obvious counterpart in the JAX reference, but imports nothing of it: the
two packages meet only in the tests, as numpy arrays (``convert.py``).
Entry points take an explicit ``device`` that defaults to ``"cuda"``; the
CPU is used only when a caller passes ``device="cpu"``, and then every
kernel wrapper runs its plain PyTorch version.
"""
