"""Model zoo of the port: the GPT LM (dense or Switch MoE; served by the
serving slice, trained by the training slice, pipelined by
`stack_gpt_blocks` / `gpt_pipeline_forward`), ResNet v1.5 (the S-SGD headline), VGG16
and InceptionV3 (the rest of the reference's benchmark trio), the BERT
encoder (local, ring or Ulysses attention), the SLP the elastic continuity worker and
the straggler benchmark train, the MLP of the reference's convergence
tests, and the fake-model tensor catalogs derived from them."""

from .bert import BertConfig, BertEncoder
from .fake_models import CATALOG, fake_model_catalog, model_param_sizes
from .gpt import (GPTConfig, GPTLM, KVCache, gpt_fused_loss, gpt_generate,
                  gpt_loss, gpt_loss_with_aux, gpt_pipeline_forward,
                  gpt_seq_loss, stack_gpt_blocks)
from .inception import InceptionV3
from .mlp import MLP, SLP
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18,
                     ResNet50, ResNet101)
from .vgg import VGG16

__all__ = ["BasicBlock", "BertConfig", "BertEncoder", "BottleneckBlock",
           "CATALOG", "GPTConfig", "GPTLM", "InceptionV3", "KVCache", "MLP",
           "ResNet", "ResNet18", "ResNet50", "ResNet101", "SLP", "VGG16",
           "fake_model_catalog", "gpt_fused_loss", "gpt_generate",
           "gpt_loss", "gpt_loss_with_aux", "gpt_pipeline_forward",
           "gpt_seq_loss", "model_param_sizes", "stack_gpt_blocks"]
