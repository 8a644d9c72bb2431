"""block reader: the main thread's wait for the reader's job,
prof["ingest_wait"] (host clock) over the window's block-loop
iterations, ms."""


def read(ctx):
    if not ctx["iters"] or "ingest_wait" not in ctx["prof"]:
        return None
    return ctx["prof"]["ingest_wait"] / ctx["iters"] * 1e3
