"""runner.kernels_per_epoch: device kernels the profiler saw in the traced
stretch (copies and sets left out), summed over the ranks, over the
stretch's epochs."""


def read(ctx):
    ranks = [r for r in ctx["ranks"] if r]
    if not ranks or not ranks[0]["epochs"]:
        return None
    return sum(r["kernel_count"] for r in ranks) / ranks[0]["epochs"]
