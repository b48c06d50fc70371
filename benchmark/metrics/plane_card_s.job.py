"""The plane build's time on the card (the counter plane_build.card_us:
per slab, CUDA events on the upload stream just before its upload and just
after its expand launch, summed), in seconds, mean per job of the window."""


def read(ctx):
    vals = [int(r["counts"]["plane_build.card_us"]) / 1e6 for r in ctx.reports
            if "plane_build.card_us" in r.get("counts", {})]
    return sum(vals) / len(vals) if vals else None
