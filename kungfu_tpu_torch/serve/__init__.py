"""kfserve on PyTorch: the elastic continuous-batching decode tier,
ported from `kungfu_tpu.serve`.

- the request front-end (`serve.ledger` and the `/serve/*` routes of
  `serve.frontend`, mounted on the config server) and the stateless
  admission router in front of it (`serve.router`);
- the iteration-level continuous-batching engine over the paged KV
  pool (`serve.engine`, `serve.kv_cache`, `serve.paged`), whose decode
  step launches the hand-written K3 kernel (`ops.paged_attn`) on the
  card;
- the elastic decode worker (`python -m kungfu_tpu_torch.serve.worker`)
  that leases requests from the ledger and rides the training runtime's
  membership machinery (consensus resize, survivor recovery, cold boot
  from the sharded checkpoint tier), and the harness that drives a real
  tier end to end (`serve.harness.run_serve_cluster`).
"""

from .engine import SIZES, DecodeEngine, build_lm
from .kv_cache import KVPoolExhausted, PagedKVPool
from .ledger import AdmissionFull, Request, RequestLedger

__all__ = [
    "AdmissionFull",
    "DecodeEngine",
    "KVPoolExhausted",
    "PagedKVPool",
    "Request",
    "RequestLedger",
    "SIZES",
    "build_lm",
]
