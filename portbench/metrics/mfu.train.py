"""The train step's share (%) of the card's fp32 peak: 3 × the forward
FLOPs (2 · weights multiplied per token, top-k experts only, plus causal
attention) of the real tokens of the window's steps, over the window
times 67 TFLOP/s. Padding and the checkpoint's recompute are not
counted."""
from portbench.readers import train_mfu_pct


def read(ctx):
    return train_mfu_pct(ctx)
