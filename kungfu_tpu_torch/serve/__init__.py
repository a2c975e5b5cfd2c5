"""kfserve on PyTorch: the continuous-batching decode engine over the
paged KV pool (`serve.engine` / `serve.kv_cache` / `serve.paged`),
ported from `kungfu_tpu.serve`. The request ledger (`serve.ledger`) is
here for the config server that holds it; the front-end, router and
serving worker come with slice 6c."""

from .engine import SIZES, DecodeEngine, build_lm
from .kv_cache import KVPoolExhausted, PagedKVPool

__all__ = ["DecodeEngine", "KVPoolExhausted", "PagedKVPool", "SIZES",
           "build_lm"]
