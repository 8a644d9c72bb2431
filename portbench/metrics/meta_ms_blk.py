"""block phase: prof["meta"] (host clock), the block's schedule built on
the host and uploaded (the `rx.meta` span), over the window's block-loop
iterations, ms."""


def read(ctx):
    if not ctx["iters"] or "meta" not in ctx["prof"]:
        return None
    return ctx["prof"]["meta"] / ctx["iters"] * 1e3
