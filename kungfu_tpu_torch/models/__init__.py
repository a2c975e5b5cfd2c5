"""Model zoo of the port: the dense GPT LM (served by the serving slice,
trained by the training slice) and ResNet v1.5 (the S-SGD headline)."""

from .gpt import (GPTConfig, GPTLM, KVCache, gpt_fused_loss, gpt_generate,
                  gpt_loss)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18,
                     ResNet50, ResNet101)

__all__ = ["BasicBlock", "BottleneckBlock", "GPTConfig", "GPTLM", "KVCache",
           "ResNet", "ResNet18", "ResNet50", "ResNet101", "gpt_fused_loss",
           "gpt_generate", "gpt_loss"]
