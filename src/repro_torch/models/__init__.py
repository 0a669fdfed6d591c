"""Model zoo: dense GQA, MLA + MoE, Mamba-1 SSM and hybrid (Hymba) stacks
over a dense or paged KV cache."""

from .attention import KVView
from .model import init
from .transformer import forward, init_caches, lm_logits, plan_groups

__all__ = ["KVView", "forward", "init", "init_caches", "lm_logits", "plan_groups"]
