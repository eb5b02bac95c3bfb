from repro_torch.quant import compress
from repro_torch.quant.log2 import (
    compute_scale,
    dequantize_act_u4,
    dequantize_log2,
    fake_quant_act_u4,
    fake_quant_log2,
    pack_nibbles,
    quantize_act_u4,
    quantize_log2,
    unpack_nibbles,
)

__all__ = [
    "compute_scale",
    "quantize_log2",
    "dequantize_log2",
    "fake_quant_log2",
    "quantize_act_u4",
    "dequantize_act_u4",
    "fake_quant_act_u4",
    "pack_nibbles",
    "unpack_nibbles",
    "compress",
]
