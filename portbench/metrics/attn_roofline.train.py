"""attn_roofline.train: the attention calls' least time over the attention kernels' device time."""

from portbench.readers import ATTENTION, roofline


def read(ctx):
    return roofline(ctx, "train-dpo", "attn", ATTENTION)
