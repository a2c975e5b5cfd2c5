"""Model zoo of the port: the dense GPT LM (the serving slice's model)."""

from .gpt import GPTConfig, GPTLM, KVCache, gpt_generate

__all__ = ["GPTConfig", "GPTLM", "KVCache", "gpt_generate"]
