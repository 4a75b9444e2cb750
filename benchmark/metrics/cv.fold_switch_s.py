"""cv.fold_switch_s: host-clock seconds of a fold switch, from `end_fold`
to the next fold's runner built (its eager warm-up epoch and its capture
included): each switch's span, which runs to the end of the new fold's
first chunk, less that chunk's replayed epochs at the window's steady
epoch time. The mean over the window's switches; none without one."""


def read(ctx):
    steady = [s for s in ctx["spans"] if not s["built"]]
    epochs = sum(s["epochs"] for s in steady)
    if not ctx["switches"] or not epochs:
        return None
    epoch_s = sum(s["seconds"] for s in steady) / epochs
    return sum(w["seconds"] - (w["epochs"] - 1) * epoch_s
               for w in ctx["switches"]) / len(ctx["switches"])
