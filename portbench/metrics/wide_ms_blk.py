"""wide carriers: prof["wide"] (host clock), every wide carrier's own
receiver advanced over its stream (`_step_wide`), over the window's
block-loop iterations, ms; a configuration without wide carriers has no
such section."""


def read(ctx):
    if not ctx["iters"] or "wide" not in ctx["prof"]:
        return None
    return ctx["prof"]["wide"] / ctx["iters"] * 1e3
