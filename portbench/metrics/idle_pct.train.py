"""idle_pct.train: share of the traced window in which the device runs nothing."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "train-dpo")
