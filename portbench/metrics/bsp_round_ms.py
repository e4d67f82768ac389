"""bsp_round_ms: the fused loop's `bsp.step` spans in the part of a
traced window after the profiled part, all their time over all their
rounds.  Each span is timed on the device by CUDA events recorded on
the stream before and after the round's dispatch and read later, with
no synchronise: it holds the round's time on the stream between them."""


def read(run):
    spans = run.spans.get("bsp.step")
    if not spans:
        return None
    rounds = sum(args.get("rounds", 1) for _, args in spans)
    return sum(ms for ms, _ in spans) / rounds
