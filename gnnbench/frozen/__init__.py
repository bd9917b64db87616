"""A frozen copy of the port's graph generators, from which the benchmark
makes each cell's graph, labels and features."""
