"""Model step (``models/transformer.py``, ``models/moe.py``): the model
FLOPs of the tokens each tier ran in the window (real prompt tokens and
decode steps, active parameters, attention over the real context;
``hibench/flops.py``) over the window's seconds and the card's dense bf16
peak (``hibench/peaks.py``)."""
from hibench import peaks


def read(ctx):
    if not ctx.model_flops or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.model_flops / (ctx.window_s * peaks.BF16_FLOP_PER_S)
