from repro_torch.kernels.ops import (
    make_dilated_conv_op,
    make_log2_matmul_op,
    make_proto_extract_op,
)

__all__ = ["make_dilated_conv_op", "make_log2_matmul_op",
           "make_proto_extract_op"]
