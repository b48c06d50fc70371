"""The collect's pace: the seconds of the span collect summed over the
window's jobs, over the hits handed to it (the counter collect.hits)
summed over them, in microseconds a hit."""


def read(ctx):
    both = [r for r in ctx.reports
            if "collect.hits" in r.get("counts", {}) and "collect" in r.get("spans", {})]
    hits = sum(int(r["counts"]["collect.hits"]) for r in both)
    if hits <= 0:
        return None
    return 1e6 * sum(float(r["spans"]["collect"]) for r in both) / hits
