from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.ops import (
    make_dilated_conv_op,
    make_log2_matmul_op,
    make_proto_extract_op,
)
from repro_torch.kernels.ref import expand_weight
from repro_torch.kernels.tcn_block import make_block_fn

__all__ = [
    "dispatch", "ref",
    "make_dilated_conv_op", "make_log2_matmul_op", "make_proto_extract_op",
    "expand_weight", "make_block_fn",
]
