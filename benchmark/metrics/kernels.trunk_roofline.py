"""kernels.trunk_roofline: the least time of the GCN trunk's work in
the traced stretch (benchmark/work.py) over the device time of the
kernels the trace attributes to the trunk: those whose name holds one of
the names in `kernels.trunk_roofline.names` beside this file. None
where no such kernel ran."""

import os

from benchmark.trace import attributed
from benchmark.work import least_seconds

NAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "kernels.trunk_roofline.names")


def read(ctx):
    with open(NAMES) as f:
        names = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    ranks = [r for r in ctx["ranks"] if r]
    seconds = sum(attributed(r["kernels"], names) for r in ranks)
    if not seconds:
        return None
    least = sum(least_seconds(r["work"]["trunk_ops"], r["work"]["trunk_bytes"])
                for r in ranks)
    return 100.0 * least / seconds
