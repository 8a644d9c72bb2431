"""acquisition: WidebandReceiver.prof["acquire"] (host clock), mean over
the window's recordings, ms."""


def read(ctx):
    if not ctx["runs"] or "acquire" not in ctx["prof"]:
        return None
    return ctx["prof"]["acquire"] / ctx["runs"] * 1e3
