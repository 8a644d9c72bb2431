"""block phase: prof["dispatch"] (host clock), the launches of the block
phase and the start of its fetch (the `rx.dispatch` span), over the
window's block-loop iterations, ms."""


def read(ctx):
    if not ctx["iters"] or "dispatch" not in ctx["prof"]:
        return None
    return ctx["prof"]["dispatch"] / ctx["iters"] * 1e3
