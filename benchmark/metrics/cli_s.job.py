"""The discover call's CLI work outside its phases: the spans cli.parse (the
parser and parse_args), cli.prepare (the argument checks and the device)
and report (the report, its JSON log line and the closing log line),
summed per job, mean over the window's jobs that carry them."""


def read(ctx):
    names = ("cli.parse", "cli.prepare", "report")
    vals = [sum(float(r["spans"].get(n, 0.0)) for n in names)
            for r in ctx.reports if "cli.parse" in r.get("spans", {})]
    return sum(vals) / len(vals) if vals else None
