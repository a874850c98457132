"""The LM stack on PyTorch: configs and the models of the reference
package's ``models/``: GQA attention (RoPE or M-RoPE) or the Mamba, mLSTM
and sLSTM mixers (``models/ssm.py``), an FFN dense or a mixture of experts,
and the encoder-decoder's encoder and cross attention (prefill with the
``flash_attention`` kernel, decode from the KV cache or the recurrent
state, the training loss with its gradient through the backward
kernels)."""
from .config import ArchConfig, MoECfg
from .model import (decode_step, forward, init_cache, init_params,
                    lm_loss, param_count, param_shapes, params_from_numpy,
                    project_logits)

__all__ = ["ArchConfig", "MoECfg", "decode_step", "forward", "init_cache",
           "init_params", "lm_loss", "param_count", "param_shapes",
           "params_from_numpy", "project_logits"]
