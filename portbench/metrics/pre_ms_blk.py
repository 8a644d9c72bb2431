"""pre-resampler: prof["pre"] (host clock), StreamPreResampler's block
(the raw tail carried on the host, the period-matrix GEMM), over the
blocks it made (rx.counts "pre.blocks"), ms a block.  Each block of a
recording is pre-resampled once, the acquisition's inside `acquire`, so
the acquisition's blocks count as the block loop's do; a configuration
on the grid, or a receiver without the count, has none."""


def read(ctx):
    blocks = ctx["counts"].get("pre.blocks", 0)
    if not blocks or "pre" not in ctx["prof"]:
        return None
    return ctx["prof"]["pre"] / blocks * 1e3
