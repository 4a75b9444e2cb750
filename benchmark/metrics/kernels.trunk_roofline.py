"""kernels.trunk_roofline: the least time of the GCN trunk's work in
the traced stretch (benchmark/work) over the device time of the
kernels the trace attributes to the trunk: those whose name holds one of
the names in `kernels.trunk_roofline.names` beside this file. None
where no such kernel ran."""

import os

from benchmark.trace import names_beside, roofline_pct

NAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "kernels.trunk_roofline.names")


def read(ctx):
    return roofline_pct(ctx["ranks"], names_beside(NAMES), "trunk_ops", "trunk_bytes")
