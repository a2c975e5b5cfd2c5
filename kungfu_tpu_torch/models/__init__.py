"""Model zoo of the port: the dense GPT LM (served by the serving slice,
trained by the training slice), ResNet v1.5 (the S-SGD headline), the
SLP the elastic continuity worker and the straggler benchmark train, and
the MLP of the reference's convergence tests."""

from .gpt import (GPTConfig, GPTLM, KVCache, gpt_fused_loss, gpt_generate,
                  gpt_loss)
from .mlp import MLP, SLP
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18,
                     ResNet50, ResNet101)

__all__ = ["BasicBlock", "BottleneckBlock", "GPTConfig", "GPTLM", "KVCache",
           "MLP", "ResNet", "ResNet18", "ResNet50", "ResNet101", "SLP",
           "gpt_fused_loss", "gpt_generate", "gpt_loss"]
