"""other_ms_per_pair.train: device ms a pair of kernels that are neither attention nor GEMM."""

from portbench.readers import other_ms


def read(ctx):
    return other_ms(ctx, "train-dpo")
