"""Model zoo: dense GQA (with M-RoPE), MLA + MoE, Mamba-1 SSM and hybrid
(Hymba) stacks over a dense or paged KV cache, and the audio encoder."""

from .attention import KVView
from .model import init, input_batch
from .transformer import forward, init_caches, lm_logits, plan_groups

__all__ = ["KVView", "forward", "init", "init_caches", "input_batch", "lm_logits", "plan_groups"]
