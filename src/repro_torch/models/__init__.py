"""Model zoo slice: the dense GQA backbone on a paged KV pool."""

from .attention import KVView
from .model import init
from .transformer import forward, init_caches, lm_logits, plan_groups

__all__ = ["KVView", "forward", "init", "init_caches", "lm_logits", "plan_groups"]
