"""host walks: prof["walk"] + ["walk_tch3"] + ["facch"] + ["tch9"] (host
clock) over the window's block-loop iterations, ms."""

KEYS = ("walk", "walk_tch3", "facch", "tch9")


def read(ctx):
    p = ctx["prof"]
    if not ctx["iters"] or not any(k in p for k in KEYS):
        return None
    return sum(p.get(k, 0.0) for k in KEYS) / ctx["iters"] * 1e3
