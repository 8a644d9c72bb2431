"""Judge what the receiver emitted for a recording against its truth.

The truth is the plan the traffic was drawn from (scene.Plan), so this
imports nothing of the program.  Every emitted frame is looked up by
(ARFCN, GSMTap type, fn):

  wrong       a frame where the truth holds one of that type, with other
              content; a speech frame that differs from the call's, in
              order, or one too many;
  leaked      a CRC-protected frame (BCCH, CCCH, FACCH3, FACCH9) where
              nothing of that type was sent, whose content another ARFCN
              sent at that fn: another carrier decoded where it is not;
              or, on an ARFCN with two beams, whose content that ARFCN
              sent at another fn: a frame of one beam emitted as the
              other's (or at a wrong fn);
  unsent      any other CRC-protected frame where nothing of that type was
              sent: content nobody sent, as a CRC-16 passes on noise once
              in 2^16 decodes (a stray column's CCCH windows, a carrier's
              first CCCH window before its first SI1 sets the energy
              gate), or a frame put at the wrong fn or ARFCN;
  missed      a due frame of the truth (BCCH, CCCH, FACCH3, FACCH9, DKAB,
              the CSD payloads the deinterleaver owes, speech) that never
              came out right;
  unjudged    frames without a CRC where the truth holds none: the CSD
              payloads of a train's first two bursts (the deinterleaver's
              ring is still half empty) and DKABs that the tone detector
              finds in a silent TCH3 frame (a power-ratio gate on noise,
              dkab.c:122-138).  The truth cannot say what noise decodes
              to; they are counted, not compared.
"""

from __future__ import annotations

import numpy as np

from .scene import CSD, DKAB, TYPE_NAMES, Plan


def _by_content(p: Plan) -> dict:
    """(type, fn, payload) -> the ARFCNs that sent it, and ("beams",
    arfcn, type, payload) -> the fn at which an ARFCN with two beams sent
    it, made once a plan (a window replays each recording many times)."""
    if p.by_content is None:
        p.by_content = {}
        two = p.two_beams()
        for (a, t, fn), (pay, _due) in p.frames.items():
            p.by_content.setdefault((t, fn, pay), []).append(a)
            if a in two:
                p.by_content[("beams", a, t, pay)] = fn
    return p.by_content


def judge(p: Plan, sent: list, speech: dict) -> dict:
    """sent: [(arfcn, type, fn, tn, l2 bytes), ...] in emission order;
    speech: arfcn -> decoded speech frames in order (all carriers of the
    ARFCN).  Returns counts, the findings, one line each, those that are
    neither leaked nor unsent first, and `by_arfcn`: {kind: {arfcn:
    count}} of the findings."""
    seeded = {c.arfcn for c in p.carriers}
    n = dict(frames=len(sent), wrong=0, leaked=0, unsent=0, missed=0,
             unjudged=0, due=0)
    first: list[str] = []
    last: list[str] = []
    got = set()
    by_content = _by_content(p)
    by_arfcn: dict = {}

    def tell(kind, a, t, fn, extra=""):
        per = by_arfcn.setdefault(kind, {})
        per[a] = per.get(a, 0) + 1
        where = "seeded" if a in seeded else "stray"
        line = f"{kind} ARFCN {a} {where} {TYPE_NAMES.get(t, hex(t))} " \
            f"fn {fn}{extra}"
        (last if kind in ("leaked", "unsent") else first).append(line)

    for a, t, fn, _tn, l2 in sent:
        key = (a, t, fn)
        want = p.frames.get(key)
        if t == DKAB:
            l2 = bytes(int(v < 0) for v in np.frombuffer(l2, np.int8))
        if want is None:
            src = [x for x in by_content.get((t, fn, l2), []) if x != a]
            beam = by_content.get(("beams", a, t, l2))
            if t in (CSD, DKAB):
                n["unjudged"] += 1
            elif src:
                n["leaked"] += 1
                tell("leaked", a, t, fn, f" (content of ARFCN {src[0]})")
            elif beam is not None:
                n["leaked"] += 1
                tell("leaked", a, t, fn, f" (sent on it at fn {beam})")
            else:
                n["unsent"] += 1
                tell("unsent", a, t, fn)
            continue
        if want[0] == l2:
            got.add(key)
        else:
            n["wrong"] += 1
            tell("wrong", a, t, fn)
    for key, (_pay, due) in p.frames.items():
        if due:
            n["due"] += 1
            if key not in got:
                n["missed"] += 1
                tell("missed", *key)
    for a, want in p.speech.items():
        have = speech.get(a, [])
        n["due"] += len(want)
        bad = sum(x != y for x, y in zip(have, want))
        extra = max(0, len(have) - len(want))
        short = max(0, len(want) - len(have))
        n["wrong"] += bad + extra
        n["missed"] += short
        if bad or extra or short:
            per = by_arfcn.setdefault("speech", {})
            per[a] = per.get(a, 0) + bad + extra + short
            first.append(f"speech ARFCN {a}: {len(have)} frames decoded, "
                         f"{len(want)} sent, {bad} differ")
    return dict(n, findings=first + last, by_arfcn=by_arfcn)


def add_by_arfcn(total: dict, by_arfcn: dict) -> None:
    """Add judge's `by_arfcn` of one recording into `total`."""
    for kind, per in by_arfcn.items():
        tot = total.setdefault(kind, {})
        for a, v in per.items():
            tot[a] = tot.get(a, 0) + v


def rare_first(findings: list, by_arfcn: dict) -> list:
    """The findings, those of the ARFCNs with the fewest findings first
    (in their order otherwise): a lone miss on a wide carrier or a beam
    is not lost behind hundreds from one faulty column."""
    def count(line):
        a = int(line.split("ARFCN ", 1)[1].split()[0].rstrip(":"))
        return sum(per.get(a, 0) for per in by_arfcn.values())
    return sorted(findings, key=count)
