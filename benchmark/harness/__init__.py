"""The benchmark's harness: the cell spec, traffic, weights, work counts,
trace reduction, the run itself and the comparison that decides
``correct``."""
