"""kernels.spmm_roofline: the least time of the GCN propagation's work in
the traced stretch (benchmark/work: real edges and one self-loop a node at
each layer's width, the CSR adjacency and the features in and out) over
the device time of the COO SpMM kernels: those whose name holds one of
the names in `kernels.spmm_roofline.names` beside this file. None where
no such kernel ran."""

import os

from benchmark.trace import names_beside, roofline_pct

NAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "kernels.spmm_roofline.names")


def read(ctx):
    return roofline_pct(ctx["ranks"], names_beside(NAMES), "prop_ops", "prop_bytes")
