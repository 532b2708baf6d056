"""The plain reference of the benchmark: the join's semantics in PyTorch.

It works out again, from the inputs the benchmark generated, everything the
program derives for a query: the split-block Bloom filters and the rows that
survive the probe, the strata, the exact aggregate, and the with-replacement
draws of the two-way sampler with their CLT estimate and bound.  It imports
nothing of the program, and runs in float64 (or, as the control, in a lower
precision).
"""
