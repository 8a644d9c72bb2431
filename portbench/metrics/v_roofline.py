"""kernel V: the bound of the Viterbi work the profiled stretch's traffic
needed (the truth's bursts in the frames each seeded carrier processed,
work.viterbi by code), whatever the receiver decodes speculatively, over
kernel V's device time there, %."""

from portbench import work


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["families"]["V"][1] or not any(
            tr.get("bursts", {}).values()):
        return None
    nbytes, nops = work.viterbi(tr["bursts"])
    return 100.0 * work.bound_s(nbytes, nops) / tr["families"]["V"][0]
