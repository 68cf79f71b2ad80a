"""The whole model step's share (%) of the card's fp32 peak: forward
FLOPs (2 · weights multiplied per token, top-k experts only, plus causal
attention) of the real prompt and delivered tokens of the generate calls
made after the traced slice and done by the window's end (host spans of
the engine wrapper), over that stretch times 67 TFLOP/s."""
from portbench.readers import serving_mfu_pct


def read(ctx):
    return serving_mfu_pct(ctx)
