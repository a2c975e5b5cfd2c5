"""Benchmarks of the port: LM training throughput (`benchmarks.lm`)."""
