"""kungfu_tpu_torch: the PyTorch + CUDA port of kungfu_tpu.

The JAX package `kungfu_tpu` is the reference; this package is ported
to an NVIDIA H100 slice by slice and imports nothing of it (nor JAX).
Ported so far: the kfserve decode path — the paged KV pool
(`serve.kv_cache`), the paged GPT forward (`serve.paged`), the
continuous-batching engine (`serve.engine`) and the paged-attention
decode kernel as hand-written CUDA (`ops.paged_attn`,
`csrc/paged_attn.cu`); single-card GPT training (`benchmarks.lm`)
through the fused head + cross-entropy kernels (`ops.fused_ce`,
`csrc/fused_ce.cu`) and, with ``attention="flash"``, the flash-attention
kernels (`ops.flash`, `csrc/flash.cu`, and the ring hop's entry points
in `parallel.sequence`); and the S-SGD headline, ResNet-50 trained by
`optimizers.sync_sgd` over a `torch.distributed` data mesh joined from
the KF_* env (`models.resnet`, `parallel.bootstrap`, `parallel.mesh`,
`benchmarks.throughput`), beside the roofline's bandwidth suite and its
HBM streaming kernel (`benchmarks.roofline`, `ops.stream`,
`csrc/stream.cu`). The peer, libkf and elastic runtime come with later
slices.

Entry points run on the CUDA card unless the caller asks for the CPU
(`serve.build_lm(..., device="cpu")`, as the tests do).
"""

__version__ = "0.1.0"
