"""block phase: prof["phase"] (dispatch) + prof["fetch"] (the wait for its
results), host clock, over the window's block-loop iterations, ms."""


def read(ctx):
    p = ctx["prof"]
    if not ctx["iters"] or "phase" not in p:
        return None
    return (p["phase"] + p.get("fetch", 0.0)) / ctx["iters"] * 1e3
