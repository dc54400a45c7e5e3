"""mfu.train: model operations of the window over its wall time times the bf16 peak."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "train-dpo")
