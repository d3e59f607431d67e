"""Operator set: sort (centerpiece), ranking, partition, filter, aggregate,
join — the generalization of the reference's four kernels."""
