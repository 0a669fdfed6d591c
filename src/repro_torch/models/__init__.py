"""Model zoo: dense GQA (with M-RoPE), MLA + MoE, Mamba-1 SSM and hybrid
(Hymba) stacks over a dense or paged KV cache, and the audio encoder."""

from .attention import KVView
from .model import (abstract_params, active_params, count_params, init, input_batch, loss_fn,
                    model_flops, param_axes)
from .transformer import forward, init_caches, lm_logits, plan_groups

__all__ = ["KVView", "abstract_params", "active_params", "count_params", "forward", "init",
           "init_caches", "input_batch", "lm_logits", "loss_fn", "model_flops", "param_axes",
           "plan_groups"]
