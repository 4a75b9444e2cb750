"""runner.epoch_ms: host-clock milliseconds an epoch over the window's
chunks that built no runner (each a run of CUDA-graph replays ending in
one transfer): their total time over their total epochs."""


def read(ctx):
    steady = [s for s in ctx["spans"] if not s["built"]]
    epochs = sum(s["epochs"] for s in steady)
    return 1e3 * sum(s["seconds"] for s in steady) / epochs if epochs else None
