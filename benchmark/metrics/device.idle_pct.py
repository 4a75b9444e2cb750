"""device.idle_pct: the share of the traced stretch's wall in which no
device event ran: 1 − (union of the device's event intervals / the
stretch's host-clock wall), over all ranks' busy time and walls."""


def read(ctx):
    ranks = [r for r in ctx["ranks"] if r]
    wall = sum(r["window_s"] for r in ranks)
    if not ranks or not wall:
        return None
    return 100.0 * (1.0 - sum(r["busy_s"] for r in ranks) / wall)
