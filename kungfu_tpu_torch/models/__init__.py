"""Model zoo of the port: the dense GPT LM (served by the serving slice,
trained by the training slice)."""

from .gpt import (GPTConfig, GPTLM, KVCache, gpt_fused_loss, gpt_generate,
                  gpt_loss)

__all__ = ["GPTConfig", "GPTLM", "KVCache", "gpt_fused_loss",
           "gpt_generate", "gpt_loss"]
