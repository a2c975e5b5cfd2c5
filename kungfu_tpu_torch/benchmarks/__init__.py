"""Benchmarks of the port: LM training throughput (`benchmarks.lm`,
`benchmarks.flash_eff`), SyncSGD image training throughput — `bench.py`'s
headline (`benchmarks.throughput`) — and the achieved-bandwidth suite
beside the ResNet-50 step (`benchmarks.roofline`)."""
