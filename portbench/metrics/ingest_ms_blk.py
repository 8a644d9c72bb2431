"""ingest: prof["ingest"] (host clock) over the window's block-loop
iterations, ms."""


def read(ctx):
    if not ctx["iters"] or "ingest" not in ctx["prof"]:
        return None
    return ctx["prof"]["ingest"] / ctx["iters"] * 1e3
