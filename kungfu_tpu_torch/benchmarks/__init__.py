"""Benchmarks of the port: LM training throughput (`benchmarks.lm`,
`benchmarks.flash_eff`), SyncSGD image training throughput — `bench.py`'s
headline (`benchmarks.throughput`) — the achieved-bandwidth suite
beside the ResNet-50 step (`benchmarks.roofline`), cluster throughput
under a straggler by training rule (`benchmarks.straggler`), and two
kernel tools: the K2/K1 kernels of two checkouts timed in turns
(`benchmarks.kernel_ab`) and K2d's and K1's forward time split by
source variants (`benchmarks.kernel_split`)."""
