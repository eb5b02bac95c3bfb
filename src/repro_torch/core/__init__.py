# The paper's primary contribution, as composable PyTorch modules:
#   protonet  — PN-as-FC unified learning/inference (Eq. 3-8) + CL store
#   streaming — greedy dilation-aware FIFO (ring-buffer) TCN execution
#   costmodel — dual-mode PE-array/SRAM model + H100 roofline terms
from repro_torch.core import costmodel, protonet, streaming

__all__ = ["costmodel", "protonet", "streaming"]
