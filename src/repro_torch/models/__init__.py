"""The LM stack on PyTorch: configs and the GQA transformer of the
reference package's ``models/``, its FFN dense or a mixture of experts
(prefill with the ``flash_attention`` kernel, KV-cache decode, the training
loss with its gradient through the backward kernels)."""
from .config import ArchConfig, MoECfg
from .model import (decode_step, forward, init_cache, init_params,
                    lm_loss, param_count, param_shapes, params_from_numpy,
                    project_logits)

__all__ = ["ArchConfig", "MoECfg", "decode_step", "forward", "init_cache",
           "init_params", "lm_loss", "param_count", "param_shapes",
           "params_from_numpy", "project_logits"]
