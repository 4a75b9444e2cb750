"""model.step_mfu_pct: the model's FLOPs in the traced stretch (benchmark/
work.py: the published model on the real graphs, a training pass three
times its forward) over the stretch's wall times the float32 peak,
summed over the ranks."""

from benchmark.work import PEAK_FP32_FLOPS


def read(ctx):
    ranks = [r for r in ctx["ranks"] if r]
    wall = sum(r["window_s"] for r in ranks)
    if not ranks or not wall:
        return None
    return 100.0 * sum(r["work"]["model_flops"] for r in ranks) / (wall * PEAK_FP32_FLOPS)
