#!/usr/bin/env python3
"""Where the MoE model's kernel step and plain step part, layer by layer.

Runs chip_smoke.py's mixed ticks (one prefill tick of rows 16, 16, 9 and 0
tokens, one decode tick) on deepseek-v2-lite at full width
(``chip_smoke.model_setup_moe``: bf16 weights from a CUDA generator seeded
0) three ways, every MoE call routed by the first run's expert choices
(``moe.routing``), so all three dispatch the same tokens to the same
experts:

- ``kernels``: every kernel on the card (``impl="cuda"``);
- ``plain``: every plain PyTorch version (``impl="torch"``);
- ``nudged``: ``plain`` with the paged attention's output (the latent
  context, before ``w_uv``) moved by one bf16 ulp, away from zero, on as
  many randomly chosen elements in every MLA layer as the kernel's and the
  plain version's differ in at layer 0 (the one layer whose inputs are the
  same on both paths): a difference of the size two summation orders make.

It prints one JSON line a policy: for each tick, how many elements of
layer 0's attention context and attention output differ between
``kernels`` and ``plain`` and by how much at most, the hidden state's
relative L2 distance after each layer (``kernels`` vs ``plain``, ``plain``
vs ``nudged``) and the logits' (the live rows').

    python3 scripts/moe_parity_probe.py                 # chip_smoke.MOE_POLICY
    python3 scripts/moe_parity_probe.py --policy 'mla.*=int8,moe.*=int8,mlp.*=int8,*=bf16'
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def mla_layer(torch, cfg, p, x, positions, *, backend, cache, view, impl, hook):
    """``models.attention.mla_attention`` with ``hook(ctx)`` applied to the
    paged attention's output before ``w_uv``."""
    from repro_torch.models.attention import apply_rope, kv_cache_write, paged_decode_attention
    from repro_torch.models.layers import rms_norm
    from repro_torch.quant.qlinear import dense

    B, S, _ = x.shape
    h, nope, rope_d = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd, lora = cfg.v_head_dim, cfg.kv_lora_rank
    q = dense(p["wq"], x, backend=backend, name="mla.q", impl=impl).reshape(
        B, S, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = dense(p["w_dkv"], x, backend=backend, name="mla.dkv", impl=impl)
    ckv = rms_norm(p["kv_norm"], dkv[..., :lora], cfg.rms_eps)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(dkv[..., lora:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope.to(torch.float32),
                         p["w_uk"]["kernel"].to(torch.float32)).to(x.dtype)
    q_eff = torch.cat([q_abs, q_rope], dim=-1)
    comp = ((lora + rope_d) ** 0.5) / ((nope + rope_d) ** 0.5)
    kv_cache_write(cache, ("ckv", "kr"), (ckv, k_rope), view=view)
    ctx = hook(paged_decode_attention(q_eff * comp, cache, ("ckv", "kr"), "ckv", view,
                                      kv_heads=1, causal=cfg.causal, impl=impl,
                                      name="mla.paged"))
    out = torch.einsum("bshl,lhv->bshv", ctx.to(torch.float32),
                       p["w_uv"]["kernel"].to(torch.float32)).to(x.dtype)
    return dense(p["wo"], out.reshape(B, S, h * vd), backend=backend, name="mla.o", impl=impl)


def traced_step(torch, cfg, rc, params, caches, tokens, pos, lens, tables, impl, nudge=None):
    """One mixed tick as ``build_mixed_step`` runs it, unrolled over the
    layers: returns (live rows' logits, hidden state after each layer,
    layer 0's attention context, layer 0's attention output). ``nudge(ctx)``
    replaces every MLA layer's attention context."""
    from repro_torch.models.attention import KVView
    from repro_torch.models.layers import embed_lookup, mlp, rms_norm
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import (_select, lm_logits, plan_groups,
                                                torch_dtype)
    from repro_torch.quant.policy import effective_policy

    backend = effective_policy(rc).resolved()
    view = KVView(pos=pos, lens=lens, tables=tables, block_size=rc.block_size,
                  layout=rc.kv_layout)
    x = embed_lookup(params["embed"], tokens, torch_dtype(rc.dtype))
    positions = pos.long()[:, None] + torch.arange(x.shape[1], device=x.device)[None, :]
    hidden, ctx0 = [], []

    def hook(ctx):
        ctx = ctx if nudge is None else nudge(ctx)
        if not ctx0:
            ctx0.append(ctx.clone())
        return ctx

    for gi, g in enumerate(plan_groups(cfg)):
        gp, gc = params["groups"][gi], caches[gi]
        for i in range(g.repeats):
            p_i, c_i = _select(gp, i), _select(gc, i)
            for j, kind in enumerate(g.kinds):
                p, c = p_i[f"k{j}"], c_i[f"k{j}"]
                h = rms_norm(p["norm1"], x, cfg.rms_eps)
                a = mla_layer(torch, cfg, p["attn"], h, positions, backend=backend, cache=c,
                              view=view, impl=impl, hook=hook)
                if not hidden:
                    attn0 = a
                x = x + a
                h2 = rms_norm(p["norm2"], x, cfg.rms_eps)
                if kind.moe:
                    x = x + moe_ffn(cfg, p["ffn"], h2, backend=backend, impl=impl)[0]
                else:
                    x = x + mlp(p["ffn"], h2, cfg.mlp_type, backend=backend, impl=impl)
                hidden.append(x.float())
    x = rms_norm(params["final_norm"], x, cfg.rms_eps)
    idx = torch.clamp(lens.long() - 1, 0, tokens.shape[1] - 1)
    h_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    live = (lens > 0).nonzero().flatten()
    logits = lm_logits(cfg, rc, params, h_last, impl=impl)[:, 0, :].float()
    return logits[live], [t[live] for t in hidden], ctx0[0], attn0


def ticks(torch, cfg, rc, params, impl, forced=None, nudges=None):
    """chip_smoke._mixed_ticks' two ticks through ``traced_step``: returns
    ([traced_step's tuple per tick], the MoE calls' expert choices)."""
    import chip_smoke
    from repro_torch.models import init_caches, moe
    from repro_torch.serve.cache import BlockManager

    dev = torch.device(chip_smoke.DEVICE)
    B, W, cap = 4, rc.prefill_chunk, 256
    mgr = BlockManager(B * cap // rc.block_size, rc.block_size, B, cap)
    rng = torch.Generator().manual_seed(3)
    lens = torch.tensor([16, 16, 9, 0], dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B, W), generator=rng, dtype=torch.int32)
    for b in range(B):
        mgr.extend(b, int(lens[b]) + 1)
    tables = torch.from_numpy(mgr.tables.copy()).to(dev)
    dec = torch.zeros((B, 1), dtype=torch.int32)
    dec[:, 0] = torch.tensor([11, 22, 33, 0])
    steps = [(tokens, torch.zeros(B, dtype=torch.int32), lens),
             (dec, lens, (lens > 0).to(torch.int32))]
    out = []
    with torch.no_grad(), moe.routing(forced) as routed:
        caches = init_caches(cfg, rc, B, cap, num_pages=mgr.num_pages, device=dev)
        for t, (tok, pos, ln) in enumerate(steps):
            out.append(traced_step(torch, cfg, rc, params, caches, tok.to(dev), pos.to(dev),
                                   ln.to(dev), tables, impl,
                                   None if nudges is None else nudges[t]))
    return out, routed


def ulp_nudger(torch, count: int, seed: int):
    """A function moving ``count`` random elements of a bf16 tensor one ulp
    away from zero (a fresh draw at every call)."""
    g = None

    def nudge(a):
        nonlocal g
        if g is None:
            g = torch.Generator(device=a.device).manual_seed(seed)
        flat = a.contiguous().view(-1).clone()
        pick = torch.randperm(flat.numel(), generator=g, device=a.device)[:count]
        bits = flat.view(torch.int16)
        bits[pick] += 1
        return flat.view(a.shape)
    return nudge


def rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def probe(torch, cfg, rc, params) -> dict:
    kern, routed = ticks(torch, cfg, rc, params, "cuda")
    plain, _ = ticks(torch, cfg, rc, params, "torch", forced=routed)
    rec = {"policy": rc.quant_policy, "layers": cfg.num_layers, "ticks": []}
    counts = []
    for (lk, hk, ck, ak), (lp, hp, cp, ap) in zip(kern, plain):
        counts.append(int((ck != cp).sum()))
        rec["ticks"].append({
            "ctx0_elements": ck.numel(), "ctx0_differ": counts[-1],
            "ctx0_max_abs": (ck.float() - cp.float()).abs().max().item(),
            "ctx0_rel_l2": rel(ck.float(), cp.float()),
            "attn0_differ": int((ak != ap).sum()),
            "attn0_max_abs": (ak.float() - ap.float()).abs().max().item(),
            "kernels_vs_plain_hidden_rel_l2": [rel(a, b) for a, b in zip(hk, hp)],
            "kernels_vs_plain_logits_rel_l2": rel(lk, lp)})
    nudged, _ = ticks(torch, cfg, rc, params, "torch", forced=routed,
                      nudges=[ulp_nudger(torch, n, 11 + t) for t, n in enumerate(counts)])
    for t, ((lp, hp, cp, _), (ln, hn, cn, _)) in enumerate(zip(plain, nudged)):
        rec["ticks"][t]["nudged_ctx0_rel_l2"] = rel(cn.float(), cp.float())
        rec["ticks"][t]["plain_vs_nudged_hidden_rel_l2"] = [rel(a, b) for a, b in zip(hn, hp)]
        rec["ticks"][t]["plain_vs_nudged_logits_rel_l2"] = rel(ln, lp)
    return rec


def main(argv=None) -> int:
    import torch

    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", action="append",
                    help="quantization policy (repeatable; default chip_smoke.MOE_POLICY)")
    ap.add_argument("--layers", type=int, default=None, help="cut depth (default all 27)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.MOE_LAYERS = args.layers
    cfg, rc, params, _ = chip_smoke.model_setup_moe(torch)
    for policy in args.policy or [chip_smoke.MOE_POLICY]:
        rc_p = dataclasses.replace(rc, quant_policy=policy)
        print(json.dumps(probe(torch, cfg, rc_p, params)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
