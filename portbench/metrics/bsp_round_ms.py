"""bsp_round_ms: the fused loop's `bsp.step` spans in the part of a
traced window after the profiled part, all their time over all their
rounds.  With tracing on the span waits for the round's loss, so it
holds the round's device time and its own synchronise."""


def read(run):
    spans = run.spans.get("bsp.step")
    if not spans:
        return None
    rounds = sum(args.get("rounds", 1) for _, args in spans)
    return sum(ms for ms, _ in spans) / rounds
