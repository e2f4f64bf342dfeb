"""Model step (``models/transformer.py`` through the L tier's chunk lane):
device milliseconds per tick of the operations whose launching runtime
call lies inside a ``hi.L.chunk`` range (by correlation id), over the
traced wave's ``hi.tick`` ranges (``hibench/lanes.py``)."""


def read(ctx):
    lanes = getattr(ctx, "lanes", None)
    if not lanes or not lanes["device_ops"] or not lanes["ticks"]:
        return None
    row = lanes["rows"].get("L.chunk")
    if row is None:
        return None
    return 1e3 * row["device_s"] / lanes["ticks"]
