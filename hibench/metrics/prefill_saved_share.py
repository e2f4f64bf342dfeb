"""KV pool (``serving/kv_pool.py``): prompt tokens served from the prefix
cache (the pools' ``tokens_saved``, both tiers) over the padded prompt
tokens admitted to both tiers in the window."""


def read(ctx):
    if not ctx.prompt_admitted:
        return None
    return 100.0 * ctx.prefix_saved / ctx.prompt_admitted
