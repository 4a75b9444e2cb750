"""mesh.rank_idle_spread_pct: the largest rank's `device.idle_pct` less
the smallest's, over a cell's ranks; none on one card."""


def read(ctx):
    ranks = [r for r in ctx["ranks"] if r]
    if len(ranks) < 2:
        return None
    idle = [100.0 * (1.0 - r["busy_s"] / r["window_s"]) for r in ranks]
    return max(idle) - min(idle)
