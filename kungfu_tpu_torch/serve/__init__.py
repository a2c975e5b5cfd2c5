"""kfserve on PyTorch: the continuous-batching decode engine over the
paged KV pool (`serve.engine` / `serve.kv_cache` / `serve.paged`),
ported from `kungfu_tpu.serve`. The request ledger, front-end, router
and elastic worker come with a later slice."""

from .engine import SIZES, DecodeEngine, build_lm
from .kv_cache import KVPoolExhausted, PagedKVPool

__all__ = ["DecodeEngine", "KVPoolExhausted", "PagedKVPool", "SIZES",
           "build_lm"]
