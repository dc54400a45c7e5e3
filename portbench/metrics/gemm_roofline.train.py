"""gemm_roofline.train: the linear layers' least time over the GEMM kernels' device time."""

from portbench.readers import GEMM, roofline


def read(ctx):
    return roofline(ctx, "train-dpo", "gemm", GEMM)
