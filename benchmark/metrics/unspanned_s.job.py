"""The seconds of a discover call in no span: the report's call_seconds
(its recorder open to close) less its spans at top level (top_spans), mean
per job of the window."""


def read(ctx):
    vals = [float(r["call_seconds"])
            - sum(float(s) for s in r["top_spans"].values())
            for r in ctx.reports if "call_seconds" in r and "top_spans" in r]
    return sum(vals) / len(vals) if vals else None
