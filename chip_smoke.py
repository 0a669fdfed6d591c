#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — ``nvidia-smi`` name and power limit, torch/CUDA versions; TF32
   is switched off for every float32 product.
2. build — compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for sm_90a,
   one compiler process per source, all at once.
3. kernel checks — each hand-written kernel against its plain PyTorch
   version at the shapes of qwen3-0.6b's serving paths, with medians of the
   kernel, the plain version and a library yardstick the port never calls
   (``torch._int_mm`` for the GEMMs, ``scaled_dot_product_attention`` for
   attention, ``abs().amax`` for the absmax reductions), and each call's
   bound on an H100 SXM (3.35 TB/s HBM3, 1979 dense int8 TOP/s, 67 f32
   TFLOP/s outside the tensor cores). The int8 GEMM also with its cycle
   statistics (``collect_stats``), bit for bit, in every int8 case.
3b. check_stats — the cycle-statistics routes, bit for bit, dtypes
   included: the assembly kernel ``tugemm_stats`` on real fused-GEMM maxima
   at the seven layer shapes (dynamic, int8 prequant, packed int2 and int4),
   ``ops.matmul_fused`` and ``ops.matmul_int8`` with stats (the GEMM
   routes), and the standalone ``unary_step_stats`` (both maxima in one
   launch, then the assembly); each route's device time and device
   operations a call are read by the last phase beside the composition
   they replace (the GEMM, then ``colabsmax``, ``rowabsmax`` and the eight
   PyTorch ops of ``kernels/ref.py::assemble_stats_ref``).
3c. check_moe_gemm — the fused GEMM's expert axis: ``ops.matmul_fused``
   with stats over deepseek-v2-lite's 64 experts at M=16 (gate/up
   2048->1408, down 1408->2048; int2 quantized on load and packed), bit for
   bit against its plain version, one GEMM launch and one ``tugemm_stats``
   launch a call (asserted; the last phase asserts 3 device operations,
   the memset included), ``torch.bmm`` on the bf16 operands as the
   library; then the model's 2-D GEMMs of widths the dense path never ran
   (N=576, K=10944, 2816) at M=64 and 4.
3c'. check_expert_int_gemm (its lines read ``check_moe_gemm``) — rows 3
   and 4 over the experts, as the unfused expert route calls them: one MoE
   layer's 3 expert GEMMs over the 64 experts at M=16 on int2 codes,
   ``ops.matmul_int8`` with stats and ``ops.matmul_packed``, one launch a
   call over all experts, bit for bit against the plain versions; library
   ``torch.bmm`` on the bf16 operands.
3d. check_ssm_gemm (run after 9b, when deepseek's weights are gone) — the
   fused GEMM at the SSM and hybrid widths (falcon-mamba-7b's and
   hymba-1.5b's SSM projections, hymba's attention and MLP; hymba's
   ``ssm.dt`` has K = 100), int8 and int2, M = 4, 64, 128 and 1,100 for
   hymba's ``ssm.in_proj``, bit for bit against the plain version.
4. step parity — one prefill tick and one decode tick of the mixed step at
   full width through the kernels and through the plain versions.
5. serve — the paged scheduler serves 8 requests on qwen3-0.6b at full
   width (random weights from a seed) under the fused dynamic policy; the
   kernels' launch counters are zeroed just before and read just after.
5b. serve_chaos / serve_fallback / serve_overload — the serving
   robustness layer on the same model. ``serve_chaos``: per-token scales
   (``ROBUST_POLICY``), fault-free and then under a generated ``FaultPlan``
   (allocation failures, preemption storms, transient NaN logits): the same
   greedy tokens, no page leaked. ``serve_fallback``: a persistent NaN on
   one row escalates it to the ``*=bf16`` fallback step, which runs on the
   card (attention's kernel, no GEMM kernel); the other rows' tokens are
   unchanged. ``serve_overload``: bounded class queues, TTLs and tenant
   budgets under a burst: every request done or structurally rejected, the
   ladder up to ``shed`` and back to ``healthy``.
5a. serve_dense — the same Scheduler and requests on ``kv_layout="dense"``
   (no block tables; attention through plain ``blockwise_attention``): only
   the fused GEMM and its stats launch; tokens equal to the paged serve's
   printed, not gated (another attention float order).
5c. prefix caching and speculative decoding on the same model, under
   ``ROBUST_POLICY``: ``serve_spec`` (γ=4, ``*=int2`` draft),
   ``serve_spec_selfdraft`` (the draft at the target's policy: acceptance
   near 1) and ``serve_spec_prequant`` (``*=int2:prequant``: a second,
   packed int2 view), on ``SPEC_REQUESTS`` = 4 of the requests, each give
   the plain serve's tokens and final KV lengths of those requests;
   ``serve_prefix`` (a shared 96-token prefix, 10 requests, the
   cache off then on: the same tokens, at least 8 forks, fewer prefill
   tokens); ``serve_prefix_spec`` (both at once) and ``cow_copy`` (a forced
   copy-on-write drained into every leaf of the target and draft pools,
   exactly). Only the fused GEMM, its stats assembly and attention launch.
5d. serve_graphs — the compiled steps (``serve/graphs.py``): 4 requests
   through the eager step, then through the CUDA graphs, on qwen3-0.6b at
   full width (fused dynamic, the γ=4 spec serve, and after the surgery
   below the packed MLP) and, in the mesh group, deepseek-v2-lite at 4
   layers: tokens, KV lengths, ``cycles_by_bits`` (per request and total),
   MoE drops, kernel counts (credited on each replay; ``serve_traced``
   holds those against the profiler) and paths identical. Every other one-card
   Scheduler phase runs the graphed step: one eager call a step and width,
   replays after it (``graphed_gate``; each record's ``step_counts``); the
   fallback step stays eager.
6. serve_prequant / step parity / serve_unfused — the same requests on the
   same weights after ``apply_surgery``: fused GEMMs on offline-packed MLP
   weights, then the legacy unfused pipeline (int8 GEMM with its stats
   assembled by ``tugemm_stats``, plane-packed GEMM; no fused GEMM and no
   ``colabsmax`` / ``rowabsmax`` launch), whose greedy tokens must equal the
   fused-prequant serve's token for token (the two paths are bit-exact).
7. check_c1 — the C1 validation path's kernels (``quantize_sym``,
   ``temporal_unary_gemm``) against their plain versions, exactly, on the
   layer-0 weights and activations of qwen3-0.6b at full width;
   ``quantize_sym`` also on a ragged x and on x off 16-byte alignment, and
   through ``ops.quantize_sym`` with each scale form (a float, 0-d, (N,),
   (1, N)) against that op's plain route.
8. c1_validation — the paper's C1 conformance, exactly: the gate-level
   simulator, ``core.tugemm``, the temporal kernel, the int8 kernel with its
   own stats and the fused kernel's stats agree on outputs, per-step
   cycles and serial/parallel totals on the 12 Table I design points and
   the paper's corners; at full width (the seven layer-0 GEMMs, operands
   made by ``quantize_sym``) the four non-simulator legs agree. Counts are
   zeroed just before and read just after.
9. quickstart — ``repro_torch.quickstart.main`` on qwen3-0.6b at full width:
   exact ``tugemm``, the simulator, PPA, and a ``*=int8:stats`` forward on
   the kernels with its energy report; the forward's cycle totals through
   the plain versions are printed beside them.
9b. the MLA + MoE slice on deepseek-v2-lite at full width (27 layers, or the
   printed ``MOE_LAYERS`` cut; bf16 weights drawn on the card from a CUDA
   generator seeded 0): ``step_parity_moe`` (kernels against the plain
   GEMM and stats versions with attention on its kernel: logits and every
   MoE layer's router choices identical; against all plain versions, read
   only), then ``serve_moe`` (``mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16``)
   and ``serve_moe_prequant`` (after ``apply_surgery``, the experts from
   packed int2 planes): the same 8 requests, only the fused GEMM, the
   stats assembly and attention launching, every call site on the cuda
   route; tokens/s, tick ms, launches and MoE drops a tick. Then the
   unfused expert route on the same weights: ``serve_moe_unfused``
   (``mla.*=int8,moe.*=int2:unfused,*=bf16``: each expert GEMM one
   ``tugemm_int8`` launch with stats over the 64 experts) and
   ``serve_moe_unfused_prequant`` (``moe.*=int2:prequant:unfused``: one
   ``tugemm_packed`` launch over the experts' planes; the shared experts,
   which ``moe.*`` also takes, run the route's 2-D calls), each on the first
   ``MOE_UNFUSED_REQUESTS`` of the requests; every expert GEMM call of both
   held bit for bit against its plain arithmetic, the same tokens and int8
   cycles from both.
9c. the legacy dense-slot Engine at full width, bf16 weights drawn on the
   card: ``serve_ssm`` (falcon-mamba-7b, 64 layers, ``ssm.*=int8,*=bf16``)
   and ``serve_hybrid`` (hymba-1.5b, 32 layers,
   ``attn.*=int8,ssm.*=int8,mlp.*=int2,*=bf16``, int8 dense KV) on
   ``ENGINE_REQUESTS`` = 4 of the requests, then ``serve_hybrid_long``
   (one 1,100-token prompt at capacity 1,152: the sliding window and a
   second KV chunk). Each runs through the kernels and through the plain
   versions: identical greedy tokens and
   per-request ``cycles_by_bits``, only ``tugemm_fused`` and
   ``tugemm_stats`` launching (no ``flash_paged_decode``); tokens/s, step
   and prefill ms, launches a decode step, weight GB and peak memory.
9d. the last archs' model paths at full width, each drawn on the card after
   the previous model is freed: ``encode_audio`` (hubert-xlarge, 48 layers,
   4 clips of 1,000 stub frames, ``attn.*=int8,mlp.*=int2,*=bf16``; the
   no-cache non-causal encoder through the kernels against the plain
   versions: per-frame argmax and ``cycles_by_bits`` identical; frames/s);
   ``serve_vl`` (qwen2-vl-7b, 28 layers: the mixed step with M-RoPE at t =
   h = w bit for bit against the RoPE step, step parity, then the serve
   phase's 8 requests under ``POLICY``); ``serve_llama4`` and
   ``serve_llama4_prequant`` (llama4-maverick, depth cut to 2 layers: a
   dense and an MoE layer of 128 experts top-1 with the shared expert,
   ~37 GB; ``step_parity_llama4``, then the serves fused dynamic and with
   packed int2 experts). Each prints its seconds and peak memory.
9e. the serving CLI, the last three dense archs and static scales, each
   model drawn on the card after the previous one is freed, each phase
   printing the bytes allocated as it starts: ``check_dense_widths``
   (``tugemm_fused`` bit for bit at every distinct layer width of
   qwen3-8b, qwen3-14b and smollm-360m at M = 64 and 4, int8 and int2
   quantized on load and packed int2, plus static scales at half the
   operand's absmax, whose codes clip; ``flash_paged_decode`` at
   smollm's group 3 with head_dim 64, qwen3-14b's group 5 and qwen3-8b's
   group 4, Sq 1 and 16, int8 pools, within ``ATTN_TOL``);
   ``serve_cli_qwen3_8b`` and ``serve_cli_smollm``
   (``repro_torch.launch.serve.main`` in-process at full width with
   ``CLI_ARGS``: every request done with nonzero ``cycles_by_bits``, only
   the fused kernels launching); ``serve_qwen3_14b`` (40 layers, ~29.5 GB:
   ``step_parity_qwen3_14b``, then the serve under ``PREQUANT_POLICY``
   after ``apply_surgery``); ``calibrate_static`` (smollm-360m under
   ``*=int8``: a calibration forward, then ``static_scales`` and
   ``collecting()`` through the kernels and the plain versions: layer 0's
   every record identical, layer 0's q/k/v named first, the expected max
   within ``CALIB_EMAX_TOL``)
   and ``edge_deployment`` (``repro_torch.edge_deployment.main`` on the
   card).
10. device_time — the device time and device launches of each fused GEMM,
   int8 GEMM, attention and temporal-GEMM case checked above, of the
   unfused path's M=64 packed-GEMM and absmax cases, of the stats routes
   (and of the compositions they replace), of the C1 path's
   serve-policy ``quantize_sym`` operands (through ``ops.quantize_sym`` as
   ``c1_operands`` calls it: one device operation a call), its ragged and
   misaligned cases, and of each one's library
   yardstick, read from ``torch.profiler`` last, so that the
   profiler runs during no other timed phase; where the profiler loses
   device events, all of them are read by CUDA events, and each record's
   ``device_ms_source`` says which.
10a. training — qwen3-0.6b at full width, after ``device_time`` has
   freed the checked cases' operands and before ``serve_traced``; each
   phase prints the bytes allocated as it starts. ``train_dense``
   (``repro_torch.launch.train.main``: bf16, remat ``block``, 8 x 512
   tokens, ``TRAIN_STEPS`` = 15 steps, lr 1e-3, a checkpoint directory
   under ``build/``; loss and grad norm finite, the last 5 steps' mean loss 0.5 nats below
   the first 5's; tokens/s, step p50/p99, peak memory, the share of the
   989 TFLOP/s bf16 peak from ``model_flops``), ``train_then_serve`` (its
   checkpoint restored bit for bit and 4 requests served under
   ``ROBUST_POLICY`` on the kernels: tokens and ``cycles_by_bits`` equal
   to a serve of the weights in memory), ``train_int8_state`` (int8
   moments and int8 EF for 10 steps: finite, falling; the state's bytes
   against f32 moments'), ``train_resume`` (4 layers: 6 steps against 3 +
   ``InjectedFailure`` + a resume + 3, every state leaf bit for bit under
   deterministic algorithms), ``train_parity_f32`` (2 layers, one f32 step
   on 2 x 64 tokens on the card and on the host: the loss to 1e-5, every
   parameter leaf to 1e-4 relative L2) and ``train_refuses_quantized`` (a
   ``*=int8`` step raises before any launch; the no-grad forward launches).
   ``free_qwen3_phases``, after the quickstart, prints what the
   qwen3-0.6b phases held on the card, by owner, and frees it.
10b. serve_traced — ``TRACED_REQUESTS`` of the serve phase's requests
   untraced and with a ``Tracer`` and a ``MetricsRegistry`` (off, on: tick,
   TTFT and inter-token ms), then traced inside ``obs.device_trace``
   (tokens and cycles identical everywhere, the host trace valid, the
   profiler trace holding the ``serve/step`` and ``serve/logits`` ranges
   and the kernels). The traced serve replays its steps as CUDA graphs, so
   a wrapper counts its launches at the capture and the graph credits them
   on each replay (``serve/graphs.py``); the kernel events of the trace,
   counted by name (``SERVE_DEVICE_KERNELS``), must equal those credited
   counts, each of the fused serve's three kernels. The kernels line prints
   both (``serve_traced_launches``).
10b. the dp x tp mesh (``MESH_DP`` x ``MESH_TP`` ranks; gloo ranks sharing
   the card when it is the only one, nccl with a card a rank):
   ``check_mesh_rank`` (every mesh kernel at one rank's shapes against its
   plain version; attention's rank slice bit for bit the full launch's
   with ``plan_dims``), ``serve_mesh`` (qwen3-0.6b cut to
   ``MESH_DENSE_LAYERS`` layers, tokens and cycles equal to its one-card
   serve's) and ``serve_mesh_moe`` (deepseek-v2-lite cut to
   ``MESH_MOE_LAYERS`` layers against its one-card serve, drops
   included); every rank launches the four mesh kernels and no plain
   version.
10c. dp x tp training (``MESH_TRAIN`` = 2 x 2 ranks of ``Trainer(mesh=)``,
   after the serving mesh; no tuGEMM kernel: training runs ``*=bf16``):
   ``train_mesh_parity`` and ``train_mesh_parity_int8_ef`` (qwen3-0.6b at
   full width, 2 layers, f32, 3 steps on 2 x 64 tokens against the one-card
   ``Trainer`` on the same weights and batches: the loss to 1e-5 relative,
   every gathered parameter leaf to 1e-4 relative L2, 2e-3 with int8
   moments and ``int8_ef``), ``train_mesh`` (``MESH_TRAIN_LAYERS`` = 8
   layers, bf16, remat ``block``, 8 x 512 tokens, 10 steps: finite and
   falling; every rank's state bytes at most its specs' share, beside the one-card state's; step
   p50; a step's bytes on the wire by collective; a checkpoint),
   ``train_mesh_then_serve`` (that checkpoint restored into the one-card
   model bit for bit against the gathered state and served under
   ``ROBUST_POLICY`` on the kernels: tokens and ``cycles_by_bits`` equal),
   ``train_mesh_moe`` (deepseek-v2-lite cut to ``MESH_MOE_LAYERS`` layers,
   experts over ``model``: 3 bf16 steps, finite) and
   ``train_mesh_moe_parity`` (2 layers, f32, as ``train_mesh_parity``),
   ``train_mesh_ssm`` (falcon-mamba-7b at full width cut to
   ``MESH_SSM_LAYERS`` layers, its mixer cut over ``inner``) and
   ``train_mesh_hybrid_sp`` (hymba-1.5b at full width cut to
   ``MESH_HYBRID_LAYERS`` layers under ``seq -> model``, attention and the
   vocab whole on every rank): ``MESH_ARCH_STEPS`` bf16 steps each, finite
   and falling, no kernel launched, then the f32 parity at 2 layers
   (``*_parity``). Each prints its seconds and the peak allocation of every
   rank.
11. the seconds of each group of phases (``phase_seconds``), the kernels
   line, then the device line last. A kernel's ``launches`` and
   ``launches_by_path`` are its wrapper's counts; on a graphed serve those
   are counted at each capture and credited on each replay, and
   ``serve_traced_launches`` sets the credited count of the traced serve
   beside the kernel events its profile holds.

Any failed check raises, and the script exits non-zero. It needs one CUDA
device and exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# train_resume runs under torch.use_deterministic_algorithms, which needs a
# fixed cuBLAS workspace set before cuBLAS starts (before torch is imported)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# every kernel's bound and its counts come from the port's roofline: the
# ``h100`` profile's rates (HBM3, dense int8, f32 outside the tensor cores,
# dense bf16) and ``kernel_cost``'s formulas, which the dry-run charges too
from repro_torch.roofline.analysis import HW_PROFILES  # noqa: E402
from repro_torch.roofline.kernel_cost import attn_bytes_ops as _attn_bytes_ops  # noqa: E402
from repro_torch.roofline.kernel_cost import bound as _bound  # noqa: E402
from repro_torch.roofline.kernel_cost import gemm_grid  # noqa: E402

H100 = HW_PROFILES["h100"]
HBM_BYTES_PER_S = H100.hbm_bw
ARCH = "qwen3-0.6b"
DEVICE = "cuda"
# the MLA + MoE slice: deepseek-v2-lite at full width, all 27 layers (a cut,
# never below 4, is printed on its phases' lines as "layers")
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_LAYERS = None
MOE_POLICY = "mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16"
MOE_PREQUANT_POLICY = "mla.*=int8,moe.*=int2:prequant,mlp.*=int2:prequant,*=bf16"
# the unfused expert route on the same weights: the expert GEMMs through the
# int8 GEMM (row 3) and, packed, the plane-packed GEMM (row 4) over all experts
MOE_UNFUSED_POLICY = "mla.*=int8,moe.*=int2:unfused,*=bf16"
# the unfused expert serves check every expert GEMM call against its plain
# arithmetic: one wave of 4 of the serve phase's 8 requests (kept to 4 for the
# script's time limit)
MOE_UNFUSED_REQUESTS = 4
MOE_UNFUSED_PREQUANT_POLICY = "mla.*=int8,moe.*=int2:prequant:unfused,*=bf16"
# the last three archs' model paths at full width: hubert-xlarge's encoder on
# 4 clips of 1,000 stub frames (20 s of audio each at HuBERT's 20 ms frame
# stride), qwen2-vl-7b's M-RoPE serve, llama4-maverick's interleaved top-1
# MoE with its depth cut (one card holds 2 of its 48 layers' expert stacks)
AUDIO_ARCH, AUDIO_CLIPS, AUDIO_FRAMES = "hubert-xlarge", 4, 1000
AUDIO_POLICY = "attn.*=int8,mlp.*=int2,*=bf16"
# the encoder's kernel and plain runs differ only in the fused GEMM (bit for
# bit) and run the same plain attention: hidden states held to this relative
# L2 (one bf16 rounding step would show as ~2**-8 at a few elements)
AUDIO_REL_TOL = 1e-3
VL_ARCH = "qwen2-vl-7b"
LLAMA4_ARCH, LLAMA4_LAYERS = "llama4-maverick-400b-a17b", 2
LLAMA4_POLICY = "attn.*=int8,mlp.*=int2,moe.*=int2,*=bf16"
LLAMA4_PREQUANT_POLICY = "attn.*=int8,mlp.*=int2,moe.*=int2:prequant,*=bf16"
POLICY = "attn.*=int8,mlp.*=int2,*=bf16"
# offline-packed int2 MLPs served by the fused kernel, and by the legacy
# unfused pipeline (int8 attention quantized per call, packed MLP GEMMs)
PREQUANT_POLICY = "attn.*=int8,mlp.*=int2:prequant,*=bf16"
UNFUSED_POLICY = "attn.*=int8:unfused,mlp.*=int2:prequant:unfused,*=bf16"
# (name, K, N, bits) of one qwen3-0.6b layer's GEMMs under POLICY
LAYER_GEMMS = [("attn.q", 1024, 2048, 8), ("attn.k", 1024, 1024, 8),
               ("attn.v", 1024, 1024, 8), ("attn.o", 2048, 1024, 8),
               ("mlp.gate", 1024, 3072, 2), ("mlp.up", 1024, 3072, 2),
               ("mlp.down", 3072, 1024, 2)]
# the fused GEMM holds its plain version bit for bit: outputs and stats;
# the unfused pipeline's kernels compute integers and are held exactly too
GEMM_TOL = 0.0
# attention: kernel and plain version sum in different orders in f32 (about
# 1e-6 relative); a bf16 output can then round to the neighbouring bf16
# value, one step of 2**-8 relative, so bf16 outputs are held to 2**-7
# relative, f32 outputs to 1e-5 absolute + 1e-5 relative
ATTN_TOL = {"bfloat16": (1e-6, 2.0 ** -7), "float32": (1e-5, 1e-5)}
# the C1 path's integer kernels (quantize_sym codes, temporal GEMM sums) are
# held to their plain versions exactly
C1_TOL = 0.0
# (param name, GEMM name) of layer 0's weights, in LAYER_GEMMS order
LAYER_WEIGHTS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                 ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]
# step parity: the mixed step's only float-order difference between the two
# paths is attention; a bf16 attention output that rounds the other way can
# flip a quantization code downstream (int8 attn.o, int2 MLP), which moves
# later layers. The logits are held to 10% relative L2 error per tick.
STEP_REL_TOL = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(torch, fn, reps: int = 25, flush=None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up;
    ``flush`` (a large buffer) is overwritten before each timed call so the
    operands come from device memory, as they do on the serving path."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_SPIN_NAMES: set = set()
# (check record, kernel call, library call or None[, {name: other call}]) of
# the kernels whose device time the last timing phase reads: run after every
# other phase, so the profiler it needs is never on while another phase is
# timed. Another call (a composition the kernel replaces, the GEMM without
# its stats) is read the same way into ``<name>_device_ms`` and
# ``<name>_device_launches``.
DEVICE_TIMED: list = []


def device_times(torch) -> None:
    """device_ms of every DEVICE_TIMED kernel call, library yardstick and
    other call, written into its check record and emitted; the bound share
    is bound_ms / device_ms. All calls are read by one method: profiles of
    ``PROFILE_CHUNK`` calls each, or, where one of those lost a call mark
    three times, CUDA events for every call (``device_ms_source`` says which)."""
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=DEVICE)
    entries = [(rec, call, lib_call, others[0] if others else {})
               for rec, call, lib_call, *others in DEVICE_TIMED]
    fns = [f for _, call, lib_call, others in entries
           for f in ((call,) + (() if lib_call is None else (lib_call,)) + tuple(others.values()))]
    times = device_ms_many(torch, fns, flush)
    it = iter(times)
    for rec, _, lib_call, others in entries:
        ms, source, launches, breakdown = next(it)
        rec["device_ms"], rec["device_ms_source"], rec["device_launches"] = ms, source, launches
        rec["device_kernels"] = breakdown
        rec["library_device_ms"] = None if lib_call is None else next(it)[0]
        for name in others:
            rec[f"{name}_device_ms"], _, rec[f"{name}_device_launches"], _ = next(it)
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        emit({"phase": "device_time", **{k: rec.get(k) for k in (
            "kernel", "case", "M", "K", "N", "Kp", "bits", "w_mode", "per_token", "bias", "x_dtype",
            "bn", "blocks", "splits", "chunks", "stats", "ms", "device_ms", "device_ms_source",
            "device_launches", "library_ms", "library_device_ms", "bound_ms", "bound_share",
            "bound_by", "scale_form", "device_kernels")},
            **{k: v for n in others for k, v in rec.items() if k.startswith(n + "_")}})
    del flush


def device_entry(rows: list) -> dict:
    """The kernels line's device numbers for a kernel whose ``rows`` (one
    layer's calls) were read by ``device_times``: summed device ms, its
    library's (None where a call has no library yardstick), the bound share
    and the most device launches of one call."""
    dev = sum(r["device_ms"] for r in rows)
    launches = [r["device_launches"] for r in rows]   # None from CUDA events
    libs = [r["library_device_ms"] for r in rows]
    return {"device_ms": dev, "device_ms_source": rows[0]["device_ms_source"],
            "library_device_ms": None if None in libs else sum(libs),
            "bound_share": sum(r["bound_ms"] for r in rows) / dev,
            "device_launches_per_call": None if None in launches else max(launches)}


def _device_events(torch, run):
    """Device-side events of ``run()`` under ``torch.profiler``, sorted by
    start: [(start_us, end_us, name)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA)


# calls read by one profile: each profiler session is a CUPTI start and stop,
# and a process that started some two hundred of them lost every device
# event of the later ones on the card
PROFILE_CHUNK = 16


def _profiled(torch, fns, flush, reps):
    """[(ms, launches, breakdown)] of each of ``fns`` from one profile, or
    None if it lost a call mark. Each call is queued as flush, a short
    ``torch.cuda._sleep`` (its kernel marks where a call starts), the call;
    a call's events are those after its sleep, less the next call's flush."""
    def run():
        for fn in fns:
            for _ in range(reps):
                flush.zero_()
                torch.cuda._sleep(1000)
                fn()

    events = _device_events(torch, run)
    marks = [i for i, (*_, n) in enumerate(events) if n in _SPIN_NAMES]
    if len(marks) != reps * len(fns):
        return None
    out = []
    for f in range(len(fns)):
        per_call, by_name, counts = [], {}, []
        for j in range(f * reps, (f + 1) * reps):
            i = marks[j]
            seg = events[i + 1:marks[j + 1] - 1] if j + 1 < len(marks) else events[i + 1:]
            per_call.append(sum(e - s for s, e, _ in seg) / 1e3)
            counts.append(len(seg))
            for s, e, n in seg:
                by_name[n[:60]] = by_name.get(n[:60], 0.0) + (e - s) / 1e3 / reps
        out.append((statistics.median(per_call), statistics.median(counts), by_name))
    return out


def _event_ms(torch, fn, flush, reps):
    """The median over ``reps`` flushed calls of ``fn`` of CUDA-event time;
    a sleep after the flush keeps the host's queueing of the call off it."""
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_many(torch, fns, flush, reps: int = 10) -> list:
    """[(ms, source, launches, breakdown)] of each of ``fns``: the median over
    ``reps`` flushed calls of the device time of one call, the durations of
    every device-side event the call launched, summed (both passes of
    attention, the temporal GEMM's zeroing of its output, the fused GEMM's
    stats memset), source ``"profiler"``; launches, the median count of
    those events a call; breakdown, the mean device ms of one call per
    event name. The calls are profiled ``PROFILE_CHUNK`` at a time, and a
    profile that lost a call mark is taken again, up to three times. If one
    is still short, or the profiler sees no device event at all, every call
    is timed by CUDA events instead (``_event_ms``): source
    ``"cuda_events"``, launches None, breakdown empty; a line on standard
    error says so."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    if not _SPIN_NAMES:
        _SPIN_NAMES.update(n for *_, n in _device_events(torch, lambda: torch.cuda._sleep(1000)))
    out = []
    for c in range(0, len(fns) if _SPIN_NAMES else 0, PROFILE_CHUNK):
        chunk = fns[c:c + PROFILE_CHUNK]
        got = None
        for _ in range(3):
            got = _profiled(torch, chunk, flush, reps)
            if got is not None:
                break
        if got is None:
            break
        out += [(ms, "profiler", n, by_name) for ms, n, by_name in got]
    if len(out) == len(fns):
        return out
    print(f"device_time: torch.profiler lost call marks after {len(out)} of {len(fns)} "
          "calls; every call is timed by CUDA events", file=sys.stderr, flush=True)
    return [(_event_ms(torch, fn, flush, reps), "cuda_events", None, {}) for fn in fns]


def device_ms(torch, fn, flush, reps: int = 10):
    """(ms, source, launches) of ``fn`` alone, as ``device_ms_many`` reads it."""
    ms, source, launches, _ = device_ms_many(torch, [fn], flush, reps)[0]
    return ms, source, launches


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------ kernel checks
def lib_int_mm(torch, a, b):
    """torch._int_mm(a, b) as a library yardstick, or None where cuBLASLt's
    int8 product does not take the shape (M > 16, K and N multiples of 8)."""
    M, K = a.shape
    if M <= 16 or K % 8 or b.shape[1] % 8:
        return None
    return lambda: torch._int_mm(a, b)


def check_gemm(torch, flush):
    """``tugemm_fused`` against its plain version, bit for bit (y, ca, rb):
    the serve phase's shapes at M=64 (bf16 x and out, every weight mode),
    the quickstart's (f32 x, W and out at M=32), decode (M=4), a ragged
    case per weight mode (M=37, K=333, N=65; packed K not a plane multiple)
    and per-token scales with a bias on packed weights. Every case's device
    time is read by the last phase, with ``torch._int_mm`` on the int8
    operands as its library call where cuBLASLt takes the shape."""
    from repro_torch.kernels.ops import pack_weights
    from repro_torch.kernels.packing import PLANES
    from repro_torch.kernels.ref import assemble_stats_ref
    from repro_torch.kernels.tugemm_fused import tugemm_fused
    from repro_torch.quant.quantize import compute_scale

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    records = []

    def run(case, x, wf, mode, bits, per_token, with_bias, out_dtype):
        M, K = x.shape
        N = wf.shape[1]
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        sx = compute_scale(x, bits, axis=0 if per_token else None)
        sx = sx.reshape(-1, 1) if per_token else sx.reshape(1, 1)
        planes = PLANES[bits] if mode == "packed" else 1
        if mode == "quant":
            w = wf
            sw = compute_scale(wf, bits, axis=1).reshape(1, N)
            wq = torch.clamp(torch.round(wf.float() / sw), lo, hi).to(torch.int8)
        else:
            wq = torch.randint(lo, hi + 1, (K, N), device=dev, generator=gen, dtype=torch.int8)
            w = pack_weights(wq, bits) if mode == "packed" else wq
            sw = (torch.rand(1, N, device=dev, generator=gen) * 1e-3 + 1e-4)
        if planes * w.shape[0] != K:   # packed K not a plane multiple: x padded with zeros
            x = torch.nn.functional.pad(x, (0, planes * w.shape[0] - K))
            wq = torch.nn.functional.pad(wq, (0, 0, 0, x.shape[1] - K))
        bias = (torch.randn(N, device=dev, generator=gen).to(out_dtype) if with_bias else None)
        args = (x, w, sx, sw, bias)
        kw = dict(bits=bits, w_mode=mode, collect_stats=True, out_dtype=out_dtype)
        got = tugemm_fused(*args, impl="cuda", **kw)
        want = tugemm_fused(*args, impl="torch", **kw)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        err = (got[0].float() - want[0].float()).abs().max().item()
        xq = torch.clamp(torch.round(x.float() / sx), lo, hi).to(torch.int8)
        call = lambda: tugemm_fused(*args, impl="cuda", **kw)
        lib_call = lib_int_mm(torch, xq, wq)
        ms = median_ms(torch, call, flush=flush)
        plain = median_ms(torch, lambda: tugemm_fused(*args, impl="torch", **kw), flush=flush)
        lib = None if lib_call is None else median_ms(torch, lib_call, flush=flush)
        byts = nbytes(x, w, sx, sw, bias, *got)
        ops = 2 * M * K * N
        rec = dict(kernel="tugemm_fused", case=case, M=M, K=K, N=N, w_mode=mode, bits=bits,
                   per_token=per_token, bias=with_bias, planes=planes,
                   x_dtype=str(x.dtype).split(".")[-1], out_dtype=str(out_dtype).split(".")[-1],
                   **gemm_grid(M, N, w.shape[0], planes, x.element_size()), exact=exact,
                   max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                   **_bound(byts, ops))
        emit({"phase": "check", **rec})
        if not exact or err > GEMM_TOL:
            raise AssertionError(f"tugemm_fused disagrees with its plain version: {rec}")
        records.append(rec)
        DEVICE_TIMED.append((rec, call, lib_call))

    M = 64  # max_batch * prefill_chunk of the serve phase
    shapes = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
    variants = [("quant", 8, False, False), ("quant", 8, True, False),
                ("quant", 2, False, False), ("quant", 2, True, False),
                ("int8", 8, False, False), ("packed", 4, False, False),
                ("packed", 2, False, False), ("quant", 8, False, True)]
    for K, N in shapes:
        x = torch.randn(M, K, device=dev, generator=gen).to(bf16)
        wf = (torch.randn(K, N, device=dev, generator=gen) * 0.02).to(bf16)
        for mode, bits, per_token, with_bias in variants:
            if with_bias and (K, N) != (1024, 2048):
                continue
            run("serve", x, wf, mode, bits, per_token, with_bias, bf16)
    for K, N in shapes:
        # the quickstart's forward: f32 x, W and out, 2 x 16 tokens, int8 per tensor
        x = torch.randn(32, K, device=dev, generator=gen)
        wf = torch.randn(K, N, device=dev, generator=gen) * 0.02
        run("quickstart f32", x, wf, "quant", 8, False, False, f32)
        # decode: 4 rows, the serve policy's int8 attention / int2 packed MLP
        x = torch.randn(4, K, device=dev, generator=gen).to(bf16)
        wf = (torch.randn(K, N, device=dev, generator=gen) * 0.02).to(bf16)
        run("decode", x, wf, "quant", 8, False, False, bf16)
        run("decode", x, wf, "packed", 2, False, False, bf16)
    # ragged: no dimension a multiple of any tile or 16-byte row; packed K not
    # a plane multiple
    x = torch.randn(37, 333, device=dev, generator=gen).to(bf16)
    wf = (torch.randn(333, 65, device=dev, generator=gen) * 0.02).to(bf16)
    for mode, bits in (("quant", 8), ("int8", 8), ("packed", 2)):
        run("ragged", x, wf, mode, bits, False, False, bf16)
    # K and N off the 64-row chunks and the column tiles, 16-byte rows: whole
    # chunks past the edge zero-filled by the copies
    x = torch.randn(M, 1040, device=dev, generator=gen).to(bf16)
    wf = (torch.randn(1040, 1040, device=dev, generator=gen) * 0.02).to(bf16)
    run("ragged tiles", x, wf, "quant", 8, False, False, bf16)
    # per-token scales and a bias on packed int2 weights
    x = torch.randn(M, 1024, device=dev, generator=gen).to(bf16)
    wf = torch.zeros(1024, 3072, device=dev, dtype=bf16)
    run("packed per-token bias", x, wf, "packed", 2, True, True, bf16)
    return records


def _attn_case(torch, gen, *, rows, sq, kv, group, part_dims, hdv, bs, MB, kv_dtype,
               q_dtype, alias_v=False):
    """Random paged pools + a block table per row spec (pos, lens)."""
    from repro_torch.models.attention import _quantize_kv

    dev = torch.device(DEVICE)
    B = len(rows)
    P = B * MB
    perm = torch.randperm(P, device=dev, generator=gen).reshape(B, MB).to(torch.int32)
    tables = torch.full((B, MB), P, dtype=torch.int32, device=dev)
    for b, (p, l) in enumerate(rows):
        n = -(-(p + l) // bs)
        tables[b, :n] = perm[b, :n]
    pos = torch.tensor([p for p, _ in rows], dtype=torch.int32, device=dev)
    kv_len = pos + torch.tensor([l for _, l in rows], dtype=torch.int32, device=dev)

    def pool(f):
        data = torch.randn(P + 1, bs, kv * f, device=dev, generator=gen)
        if kv_dtype == torch.int8:
            q, s = _quantize_kv(data.reshape(P + 1, bs, kv, f))
            return q.reshape(P + 1, bs, kv * f), s
        return data.to(kv_dtype), None

    parts = [pool(f) for f in part_dims]
    v, vs = parts[0] if alias_v else pool(hdv)
    q = torch.randn(B, sq, kv * group, sum(part_dims), device=dev, generator=gen).to(q_dtype)
    return (q, tuple(p for p, _ in parts), tuple(s for _, s in parts), v, vs,
            tables, pos, kv_len)


def check_attention(torch, flush):
    from repro_torch.kernels.flash_paged import split_plan

    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    gqa = dict(kv=8, group=2, part_dims=(128,), hdv=128, bs=16, MB=128)
    mla = dict(kv=1, group=16, part_dims=(512, 64), hdv=512, bs=16, MB=128, alias_v=True)
    serve = dict(gqa, MB=16)   # the serve phase's pool: capacity 256 in pages of 16
    mla_serve = dict(mla, MB=16)
    smollm = dict(kv=1, group=3, part_dims=(20,), hdv=20, bs=16, MB=16)
    # (pos, lens) per row: a long decode to 2048 tokens, a mid one, an idle
    # row (lens 0, kv_len 0: must emit exact zeros), a short one
    dec = [(2047, 1), (1000, 1), (0, 0), (16, 1)]
    pre = [(2032, 16), (500, 16), (0, 0), (0, 16)]
    # rows whose live pages end exactly on the first and on the second split
    # boundary of the decode plan, an idle row, and a row with kv_len 1
    edge = split_plan(4, 8, 2, 128, sms)[1] * 16
    edges = [(edge - 1, 1), (2 * edge - 1, 1), (0, 0), (0, 1)]
    cases = [
        ("gqa_decode_int8", gqa, dec, 1, i8, bf16, None),
        ("gqa_decode_bf16", gqa, dec, 1, bf16, bf16, None),
        ("gqa_step16_int8", gqa, pre, 16, i8, bf16, None),
        ("gqa_step16_bf16", gqa, pre, 16, bf16, bf16, None),
        ("gqa_step16_int8_f32q", gqa, pre, 16, i8, f32, None),
        ("gqa_step16_int8_window256", gqa, pre, 16, i8, bf16, 256),
        ("mla_decode_int8", mla, dec, 1, i8, bf16, None),
        ("mla_step16_int8", mla, pre, 16, i8, bf16, None),
        # the serve phase's own shape: 4 rows, a 16-wide step, 16 pages a row
        ("gqa_serve_step16_int8", serve, [(112, 16), (143, 1), (0, 0), (60, 1)], 16, i8, bf16,
         None),
        # the speculative verify step at the serve's pool: every decode row
        # judges γ+1 = 5 positions (its split plan is the decode step's)
        ("gqa_verify_int8", serve, [(112, SPEC_GAMMA + 1), (143, SPEC_GAMMA + 1), (0, 0),
                                    (60, SPEC_GAMMA + 1)], SPEC_GAMMA + 1, i8, bf16, None),
        # the MoE serve's MLA shapes: its mixed ticks (16 wide) and its
        # decode-only ticks (1 wide)
        ("mla_serve_step16_int8", mla_serve, [(112, 16), (143, 1), (0, 0), (60, 1)], 16, i8,
         bf16, None),
        ("mla_serve_decode_int8", mla_serve, [(200, 1), (143, 1), (0, 0), (60, 1)], 1, i8, bf16,
         None),
        ("gqa_decode_split_edges_int8", gqa, edges, 1, i8, bf16, None),
        # a window that leaves every split but the last one or two empty
        ("gqa_decode_int8_window256", gqa, dec, 1, i8, bf16, 256),
        # the quickstart's own shape: 2 rows of 16 tokens from position 0 in
        # one page of 16, f32 pools and f32 q (the f32 model dtype)
        ("gqa_quickstart_f32", dict(gqa, MB=1), [(0, 16), (0, 16)], 16, f32, f32, None),
        # smollm-360m_smoke's head_dim 20 (40-byte bf16 rows, 20-byte int8
        # rows): the kernel's narrow path, at the serve phase's pool
        ("smollm_smoke_step16_bf16", smollm, [(112, 16), (143, 1), (0, 0), (60, 1)], 16, bf16,
         bf16, None),
        ("smollm_smoke_decode_int8", smollm, [(200, 1), (143, 1), (0, 0), (60, 1)], 1, i8, bf16,
         None),
    ]
    return [attn_check(torch, gen, sms, flush, *case) for case in cases]


def attn_check(torch, gen, sms, flush, name, shape, rows, sq, kvt, qt, window, phase="check",
               plan_dims=None):
    """One ``flash_paged_decode`` case: random pools for ``rows`` ((pos,
    lens) each) at ``shape``, the kernel against its plain version within
    ``ATTN_TOL`` (idle rows exact zeros), timed with its plain version and
    SDPA over the gathered pages; emitted under ``phase``, appended to
    DEVICE_TIMED and returned. ``plan_dims`` is the kernel's, where given
    (a mesh rank's call takes the whole launch's split plan)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_paged import (ROW_TILE, flash_paged_decode, flash_paged_ref,
                                                 gather_pages, split_plan)

    dev = torch.device(DEVICE)
    f32 = torch.float32
    shape = dict(shape)
    args = _attn_case(torch, gen, rows=rows, sq=sq, kv_dtype=kvt, q_dtype=qt, **shape)
    kw = dict(kv_heads=shape["kv"], causal=True, window=window)
    kw_k = dict(kw, plan_dims=plan_dims)
    got = flash_paged_decode(*args, impl="cuda", **kw_k)
    want = flash_paged_ref(*args, **kw)
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL["float32" if qt == f32 else "bfloat16"]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    idle = [b for b, (_, l) in enumerate(rows) if l == 0]
    zeros = all(bool((got[b] == 0).all()) for b in idle)
    # library yardstick: SDPA over the gathered, dequantized pages
    q, kparts, kscales, v, vs, tables, pos, kv_len = args
    B, _, H, hd = q.shape
    Lk = tables.shape[1] * shape["bs"]
    kg = torch.cat([gather_pages(p, s, tables).reshape(B, Lk, shape["kv"], -1)
                    for p, s in zip(kparts, kscales)], -1)
    vg = gather_pages(v, vs, tables).reshape(B, Lk, shape["kv"], -1)
    rep = H // shape["kv"]
    kq = kg.to(qt).permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    vq = vg.to(qt).permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    qq = q.permute(0, 2, 1, 3)
    kpos = torch.arange(Lk, device=dev)
    qpos = pos.long()[:, None] + torch.arange(sq, device=dev)
    mask = (kpos[None, None, :] < kv_len.long()[:, None, None]) & (
        kpos[None, None, :] <= qpos[:, :, None])
    if window is not None:
        mask = mask & (qpos[:, :, None] - kpos[None, None, :] < window)
    mask = mask[:, None]
    call = lambda args=args, kw=kw_k: flash_paged_decode(*args, impl="cuda", **kw)
    lib_call = lambda qq=qq, kq=kq, vq=vq, mask=mask: F.scaled_dot_product_attention(
        qq, kq, vq, attn_mask=mask)
    ms = median_ms(torch, call, flush=flush)
    plain = median_ms(torch, lambda: flash_paged_ref(*args, **kw), flush=flush)
    lib = median_ms(torch, lib_call, flush=flush)
    byts, flops = _attn_bytes_ops(args, shape["kv"], shape["bs"], window)
    rows_head = rep * sq
    splits, per = split_plan(*(plan_dims or (B, shape["kv"], rows_head)), tables.shape[1], sms)
    rec = dict(kernel="flash_paged_decode", case=name, B=B, sq=sq, heads=H,
               kv_heads=shape["kv"], hd_tot=hd, hdv=shape["hdv"], bs=shape["bs"],
               pages=tables.shape[1], kv_len=kv_len.tolist(),
               kv_dtype=str(kvt).split(".")[-1], q_dtype=str(qt).split(".")[-1],
               window=window, splits=splits, pages_per_split=per,
               blocks=B * shape["kv"] * -(-rows_head // ROW_TILE) * splits,
               within_tol=ok, idle_rows_zero=zeros, max_abs_err=err, tol=[atol, rtol],
               ms=ms, plain_ms=plain, library_ms=lib, **_bound(byts, flops, "f32"))
    emit({"phase": phase, **rec})
    if not (ok and zeros):
        raise AssertionError(f"flash_paged_decode disagrees with its plain version: {rec}")
    DEVICE_TIMED.append((rec, call, lib_call))
    return rec


def _flat(out) -> tuple:
    """A kernel's result as a flat tuple of tensors (a tensor, a tuple of
    tensors, or (y, TuGemmStats))."""
    return tuple(t for x in out for t in _flat(x)) if isinstance(out, tuple) else (out,)


def _exact(got, want):
    """(bit for bit with equal dtypes and shapes, max abs difference) of two
    results, each a tensor or a (nested) tuple of tensors."""
    gs, ws = _flat(got), _flat(want)
    exact = len(gs) == len(ws) and all(
        g.dtype == w.dtype and g.shape == w.shape and bool((g == w).all()) for g, w in zip(gs, ws))
    err = max(((g.double() - w.double()).abs().max().item() for g, w in zip(gs, ws)
               if g.shape == w.shape and g.numel()), default=0.0)
    return exact, err


def check_unfused(torch, flush):
    """The unfused pipeline's kernels against their plain versions, exactly,
    at the shapes of qwen3-0.6b's unfused serving path: M=64 (4 rows x chunk
    16) and M=4 (decode), plus ragged cases: for the packed GEMM, A narrower
    than its planes (K < planes*Kp) on the 16-byte and the plain-load copy
    paths, and packed rows that are not 16-byte multiples (Kp % 16 != 0).
    The M=64 calls' device time is read by the last phase."""
    from repro_torch.kernels.ops import pack_weights
    from repro_torch.kernels.packing import BITS_TO_PLANES
    from repro_torch.kernels.tugemm_int8 import tugemm_int8
    from repro_torch.kernels.tugemm_packed import tugemm_packed
    from repro_torch.kernels.unary_stats import colabsmax, rowabsmax

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4)

    def i8(shape, bits=8):
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
        t = torch.randint(lo, hi, shape, device=dev, generator=gen, dtype=torch.int8)
        t.view(-1)[0] = lo            # the most negative code is in every operand
        return t

    records = []

    def run(kernel, case, fn, plain, lib_ms, byts, ops, lib_call=None, timed=False,
            others=None, **shape):
        """one case held exactly against its plain version (a tensor or a
        tuple of them, dtypes included); ``timed``: its device time (and
        ``lib_call``'s and ``others``') is read by the last phase"""
        got, want = fn(), plain()
        torch.cuda.synchronize()
        exact, err = _exact(got, want)
        rec = dict(kernel=kernel, case=case, **shape, exact=exact, max_abs_err=err,
                   ms=median_ms(torch, fn, flush=flush),
                   plain_ms=median_ms(torch, plain, flush=flush), library_ms=lib_ms,
                   **_bound(byts, ops))
        emit({"phase": "check", **rec})
        if not exact or err > GEMM_TOL:
            raise AssertionError(f"{kernel} disagrees with its plain version: {rec}")
        records.append(rec)
        if timed:
            DEVICE_TIMED.append((rec, fn, lib_call, others or {}))

    def int8(case, a, b, c=None):
        """a tugemm_int8 case, its device time read by the last phase; then
        the same GEMM with its cycle statistics, (y, ca, rb) against the
        plain GEMM with ``colabsmax_ref`` / ``rowabsmax_ref``, its device
        time (and the GEMM's without them) read at M=64 without C"""
        M, K = a.shape
        N = b.shape[1]
        call = lambda: tugemm_int8(a, b, c, impl="cuda")
        lib_call = None if c is not None else lib_int_mm(torch, a, b)
        run("tugemm_int8", case, call, lambda: tugemm_int8(a, b, c, impl="torch"),
            None if lib_call is None else median_ms(torch, lib_call, flush=flush),
            nbytes(a, b, c) + 4 * M * N, 2 * M * K * N, lib_call, True, M=M, K=K, N=N,
            **gemm_grid(M, N, K, 1))
        run("tugemm_int8", case, lambda: tugemm_int8(a, b, c, collect_stats=True, impl="cuda"),
            lambda: tugemm_int8(a, b, c, collect_stats=True, impl="torch"), None,
            nbytes(a, b, c) + 4 * M * N + 8 * K, 2 * M * K * N, None, M == 64 and c is None,
            {"no_stats": call}, stats=True, M=M, K=K, N=N, **gemm_grid(M, N, K, 1))

    def packed(case, M, K, N, bits, rows=None):
        """a tugemm_packed case: A (M, K) against B of ``rows`` >= K logical
        rows (default: K) packed at ``bits``; the library call is
        torch._int_mm on B's first K rows, unpacked"""
        a, wq = i8((M, K)), i8((rows or K, N), bits)
        pb = pack_weights(wq, bits)
        call = lambda: tugemm_packed(a, pb, bits=bits, impl="cuda")
        lib_call = lib_int_mm(torch, a, wq[:K].contiguous())
        run("tugemm_packed", case, call, lambda: tugemm_packed(a, pb, bits=bits, impl="torch"),
            None if lib_call is None else median_ms(torch, lib_call, flush=flush),
            nbytes(a, pb) + 4 * M * N, 2 * M * K * N, lib_call, M == 64, M=M, K=K, N=N,
            bits=bits, Kp=pb.shape[0], **gemm_grid(M, N, pb.shape[0], BITS_TO_PLANES[bits]))

    gemms = [("attn.q", 1024, 2048), ("attn.k/v", 1024, 1024), ("attn.o", 2048, 1024)]
    for M in (64, 4):
        for case, K, N in gemms:
            a, b = i8((M, K)), i8((K, N))
            int8(case, a, b)
            col_lib = lambda a=a: a.abs().amax(0)
            run("colabsmax", case, lambda a=a: colabsmax(a, impl="cuda"),
                lambda: colabsmax(a, impl="torch"), median_ms(torch, col_lib, flush=flush),
                nbytes(a) + 4 * K, M * K, col_lib, M == 64, M=M, K=K)
            if M == 64:
                row_lib = lambda b=b: b.abs().amax(1)
                run("rowabsmax", case, lambda b=b: rowabsmax(b, impl="cuda"),
                    lambda: rowabsmax(b, impl="torch"), median_ms(torch, row_lib, flush=flush),
                    nbytes(b) + 4 * K, K * N, row_lib, True, K=K, N=N)
        packed("mlp.gate/up", M, 1024, 3072, 2)
        packed("mlp.down", M, 3072, 1024, 2)
        packed("int4 1024x3072", M, 1024, 3072, 4)
    M, K, N = 64, 1024, 2048
    a, b = i8((M, K)), i8((K, N))
    c = torch.randint(-(2 ** 20), 2 ** 20, (M, N), device=dev, generator=gen, dtype=torch.int32)
    int8("attn.q with C", a, b, c)
    # ragged: no dimension a multiple of any tile; packed K not a plane multiple
    a, b = i8((37, 333)), i8((333, 65))
    c = torch.randint(-99, 99, (37, 65), device=dev, generator=gen, dtype=torch.int32)
    int8("ragged", a, b, c)
    run("colabsmax", "ragged", lambda: colabsmax(a, impl="cuda"),
        lambda: colabsmax(a, impl="torch"), None, nbytes(a) + 4 * 333, 37 * 333, M=37, K=333)
    run("rowabsmax", "ragged", lambda: rowabsmax(b, impl="cuda"),
        lambda: rowabsmax(b, impl="torch"), None, nbytes(b) + 4 * 333, 333 * 65, K=333, N=65)
    for M in (64, 4):   # K, N off the chunks and tiles, 16-byte rows
        int8(f"ragged tiles {M}x1040x1040", i8((M, 1040)), i8((1040, 1040)))
    int8("M=70: two M tiles", i8((70, 1024)), i8((1024, 2048)))
    # the packed GEMM's ragged edges: no dimension a multiple of any tile, K
    # not a plane multiple; A narrower than B's planes (K < planes*Kp) with
    # 16-byte rows (the last plane's copies cut at K) and with K % 16 != 0
    # (plain loads of A); packed rows that are not 16-byte multiples
    packed("ragged", 5, 199, 70, 2)
    packed("K < planes*Kp, 16-byte rows", 64, 1008, 3072, 2, rows=1024)
    packed("K < planes*Kp, K % 16 != 0", 64, 1022, 3072, 2, rows=1024)
    packed("Kp % 16 != 0", 64, 1000, 1040, 4)
    return records


def check_stats(torch, flush):
    """The cycle-statistics routes against their plain versions, bit for bit
    with equal dtypes: ``tugemm_stats`` on the maxima of real fused GEMMs
    at the seven layer shapes (M=64: dynamic at the policy's bits, int8
    prequant, packed int2 and int4); ``ops.matmul_fused`` and
    ``ops.matmul_int8`` with stats (maxima from the GEMM's tiles, one
    assembly launch); the standalone ``unary_step_stats`` (two launches) at
    the attention shapes (M=64 and 4), ragged and at M=70. The last phase
    reads the device time and device operations a call of each route at
    M=64 beside the composition it replaces as PyTorch ops (the GEMM with
    its maxima, then the eight ops of ``assemble_stats_ref``; for the int8 GEMM and the
    standalone route, ``colabsmax`` and ``rowabsmax`` first) and the GEMM
    without stats. No single PyTorch call computes the stats (library null)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.packing import PLANES
    from repro_torch.kernels.ref import assemble_stats_ref
    from repro_torch.kernels.tugemm_fused import tugemm_fused
    from repro_torch.kernels.tugemm_int8 import tugemm_int8
    from repro_torch.kernels.unary_stats import (HDR, colabsmax, rowabsmax, tugemm_stats,
                                                 unary_step_stats)
    from repro_torch.quant.quantize import compute_scale

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(8)
    bf16 = torch.bfloat16
    records = []

    def i8(shape, lo=-128, hi=128):
        t = torch.randint(lo, hi, shape, device=dev, generator=gen, dtype=torch.int8)
        t.view(-1)[0] = lo            # the most negative code is in every operand
        return t

    def run(kernel, case, fn, plain, byts, ops_, others=None, **extra):
        """one case bit for bit against its plain version; ``others``: its
        device time and the others' are read by the last phase"""
        got, want = fn(), plain()
        torch.cuda.synchronize()
        exact, err = _exact(got, want)
        rec = dict(kernel=kernel, case=case, **extra, exact=exact, max_abs_err=err,
                   ms=median_ms(torch, fn, flush=flush),
                   plain_ms=median_ms(torch, plain, flush=flush), library_ms=None,
                   **_bound(byts, ops_))
        emit({"phase": "check_stats", **rec})
        if not exact:
            raise AssertionError(f"{kernel} disagrees with its plain version: {rec}")
        records.append(rec)
        if others is not None:
            DEVICE_TIMED.append((rec, fn, None, others))

    def stats_bytes(K, planes=1, Kw=None):
        return 4 * (2 * planes * (Kw or K) + HDR + K)

    # the assembly on real fused maxima, and the fused GEMM route
    M = 64
    for name, K, N, bits in LAYER_GEMMS:
        x = torch.randn(M, K, device=dev, generator=gen).to(bf16)
        wf = (torch.randn(K, N, device=dev, generator=gen) * 0.02).to(bf16)
        sx = compute_scale(x, bits).reshape(1, 1)
        for mode, mbits in (("quant", bits), ("int8", 8), ("packed", 2), ("packed", 4)):
            planes = PLANES[mbits] if mode == "packed" else 1
            if mode == "quant":
                w, sw = wf, compute_scale(wf, mbits, axis=1).reshape(1, N)
            else:
                lo, hi = -(2 ** (mbits - 1)), 2 ** (mbits - 1)
                wq = i8((K, N), lo, hi)
                w = ops.pack_weights(wq, mbits) if mode == "packed" else wq
                sw = torch.rand(1, N, device=dev, generator=gen) * 1e-3 + 1e-4
            kw = dict(bits=mbits, w_mode=mode, collect_stats=True, out_dtype=bf16)
            y, ca, rb = tugemm_fused(x, w, sx, sw, None, impl="cuda", **kw)
            label = f"{name} {'dynamic' if mode == 'quant' else mode} w={mbits}"
            run("tugemm_stats", label, lambda ca=ca, rb=rb, K=K: tugemm_stats(ca, rb, K,
                                                                               impl="cuda"),
                lambda ca=ca, rb=rb, K=K: tugemm_stats(ca, rb, K, impl="torch"),
                stats_bytes(K, planes, w.shape[0]), 2 * K,
                {} if mode == "quant" else None, M=M, K=K, N=N, bits=mbits, w_mode=mode,
                planes=planes)
            if mode == "int8" or (mode == "packed" and (mbits, bits) != (2, 2)):
                continue
            # the route as the serve runs it: matmul_fused with stats (dynamic,
            # and the prequant serve's packed int2 MLP); what it replaces is
            # the GEMM's launch, then the eight ops (and rb's copy when packed)
            wr = wf if mode == "quant" else w
            fused = lambda x=x, wr=wr, sx=sx, sw=sw, mbits=mbits, q=mode != "quant", \
                impl="cuda": ops.matmul_fused(x, wr, sx=sx, sw=sw.reshape(-1), bits=mbits,
                                              w_quantized=q, collect_stats=True,
                                              out_dtype=bf16, impl=impl)
            args = (x, w, sx, sw, None)

            def composition(args=args, kw=kw, K=K):
                y, ca, rb = tugemm_fused(*args, impl="cuda", **kw)
                return y, assemble_stats_ref(ca.reshape(-1)[:K], rb.t().reshape(-1)[:K])

            nostats = dict(kw, collect_stats=False)
            run("stats_route", f"fused {label}", fused, lambda f=fused: f(impl="torch"),
                nbytes(x, w, sx, sw) + 2 * M * N + stats_bytes(K, planes, w.shape[0]),
                2 * M * K * N,
                {"composition": composition,
                 "no_stats": lambda args=args, nostats=nostats: tugemm_fused(
                     *args, impl="cuda", **nostats)},
                route="fused", M=M, K=K, N=N, bits=mbits, w_mode=mode)
    # the int8 GEMM route and the standalone route
    for M in (64, 4):
        for case, K, N in (("attn.q", 1024, 2048), ("attn.k/v", 1024, 1024),
                           ("attn.o", 2048, 1024)):
            a, b = i8((M, K)), i8((K, N))
            timed = M == 64
            route = lambda a=a, b=b, impl="cuda": ops.matmul_int8(a, b, collect_stats=True,
                                                                  impl=impl)
            run("stats_route", f"int8 {case}", route, lambda r=route: r(impl="torch"),
                nbytes(a, b) + 4 * M * N + stats_bytes(K), 2 * M * K * N,
                {"composition": lambda a=a, b=b: (tugemm_int8(a, b), assemble_stats_ref(
                    colabsmax(a), rowabsmax(b))),
                 "no_stats": lambda a=a, b=b: tugemm_int8(a, b)} if timed else None,
                route="int8", M=M, K=K, N=N)
            run("unary_step_stats", case, lambda a=a, b=b: unary_step_stats(a, b, impl="cuda"),
                lambda a=a, b=b: unary_step_stats(a, b, impl="torch"),
                nbytes(a, b) + 4 * (HDR + K), M * K + K * N,
                {"composition": lambda a=a, b=b: assemble_stats_ref(colabsmax(a),
                                                                    rowabsmax(b))}
                if timed else None, M=M, K=K, N=N)
    for case, (M, K, N) in (("ragged", (37, 333, 65)), ("M=70", (70, 1024, 2048))):
        a, b = i8((M, K)), i8((K, N))
        b.view(-1)[-1] = -128
        run("unary_step_stats", case, lambda a=a, b=b: unary_step_stats(a, b, impl="cuda"),
            lambda a=a, b=b: unary_step_stats(a, b, impl="torch"),
            nbytes(a, b) + 4 * (HDR + K), M * K + K * N, M=M, K=K, N=N)
        route = lambda a=a, b=b, impl="cuda": ops.matmul_int8(a, b, collect_stats=True, impl=impl)
        run("stats_route", f"int8 {case}", route, lambda r=route: r(impl="torch"),
            nbytes(a, b) + 4 * M * N + stats_bytes(K), 2 * M * K * N, route="int8",
            M=M, K=K, N=N)
    return records


# (name, K, N, bits) of deepseek-v2-lite's GEMMs under MOE_POLICY that the
# dense path never ran: ragged N (dkv 576), K % 128 = 64 (the dense layer's
# down, 10944), and the shared experts' width 2816
DS_GEMMS = [("mla.q", 2048, 3072, 8), ("mla.dkv", 2048, 576, 8), ("mla.o", 2048, 2048, 8),
            ("mlp.gate/up", 2048, 10944, 2), ("mlp.down", 10944, 2048, 2),
            ("moe.shared.gate/up", 2048, 2816, 2), ("moe.shared.down", 2816, 2048, 2)]
# (name, K, N) of one MoE layer's expert GEMMs: 64 experts, M = 4 rows x cap 4
MOE_EXPERTS, MOE_M = 64, 16
MOE_GEMMS = [("moe.gate/up", 2048, 1408), ("moe.down", 1408, 2048)]


def fused_case(torch, phase, case, x, w, sx, sw, bits, packed, lib_call, flush, **extra):
    """One ``ops.matmul_fused`` call with stats (bf16 out) held to its plain
    version bit for bit (y and every TuGemmStats field), one GEMM launch
    and one ``tugemm_stats`` launch a call (the counters), timed with its
    plain version and ``lib_call``; emitted under ``phase``, appended to
    DEVICE_TIMED and returned."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.unary_stats import HDR

    call = lambda impl="cuda": ops.matmul_fused(
        x, w, sx=sx, sw=sw, bits=bits, w_quantized=packed, collect_stats=True,
        out_dtype=torch.bfloat16, impl=impl, name=phase)
    before = ops.kernel_counts()
    got = call()
    after = ops.kernel_counts()
    want = call("torch")
    torch.cuda.synchronize()
    launches = {k: after[k]["launches"] - before[k]["launches"] for k in after}
    exact, err = _exact(got, want)
    lead = x.shape[:-2]
    Mx, K = x.shape[-2:]
    N = sw.shape[-1]
    n_e = lead[0] if lead else 1
    byts = nbytes(x, w, sx, sw, got[0]) + 4 * n_e * (2 * K + HDR + K)   # ca, rb, stats
    rec = dict(kernel="tugemm_fused", case=case, experts=n_e, M=Mx, K=K, N=N, bits=bits,
               w_mode="packed" if packed else "quant", stats=True, **extra,
               **gemm_grid(Mx, N, w.shape[-2], 4 if packed else 1, 2, n_e),
               exact=exact, max_abs_err=err, launches_a_call=launches,
               ms=median_ms(torch, call, flush=flush),
               plain_ms=median_ms(torch, lambda: call("torch"), flush=flush),
               library_ms=None if lib_call is None else median_ms(torch, lib_call,
                                                                 flush=flush),
               **_bound(byts, 2 * n_e * Mx * K * N))
    emit({"phase": phase, **rec})
    if not exact:
        raise AssertionError(f"tugemm_fused disagrees with its plain version: {rec}")
    ran = {k: n for k, n in launches.items() if n}
    if ran != {"tugemm_fused": 1, "tugemm_stats": 1}:
        raise AssertionError(f"matmul_fused with stats is not one GEMM launch and one "
                             f"tugemm_stats launch: {rec}")
    DEVICE_TIMED.append((rec, call, lib_call))
    return rec


def int8_operands(torch, x, wf, sx, sw, bits):
    """x and W quantized as the fused GEMM quantizes them: ``torch._int_mm``'s
    operands for the library yardstick."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    xq = torch.clamp(torch.round(x.float() / sx.float()), lo, hi).to(torch.int8)
    wq = torch.clamp(torch.round(wf.float() / sw.float()), lo, hi).to(torch.int8)
    return xq, wq


def check_moe_gemm(torch, flush):
    """The expert axis of ``tugemm_fused``: ``ops.matmul_fused`` with stats
    over all 64 experts of deepseek-v2-lite at M=16 (4 rows x capacity 4),
    gate/up 2048->1408 and down 1408->2048, int2 quantized on load (the
    fused dynamic policy) and from packed planes (prequant), held to its
    plain version bit for bit (y and every TuGemmStats field, each with a
    leading (64,) axis). Some experts get no token and every expert has
    empty slots, as the dispatch leaves them. One call is one GEMM launch
    and one ``tugemm_stats`` launch (the counters; the last phase reads 3
    device operations, the memset included, and raises otherwise). Library:
    ``torch.bmm`` on the bf16 operands. Then the model's 2-D GEMMs whose
    widths the dense path never ran (M=64 and 4), bit for bit, with
    ``torch._int_mm`` on their int8 operands as the library at M=64."""
    from repro_torch.quant.quantize import act_scale, fused_scales
    from repro_torch.quant.surgery import _prequant_leaf

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(9)
    bf16 = torch.bfloat16
    E, M = MOE_EXPERTS, MOE_M
    records = []

    def run(*args):
        records.append(fused_case(torch, "check_moe_gemm", *args, flush))

    for name, K, N in MOE_GEMMS:
        x = torch.randn(E, M, K, device=dev, generator=gen).to(bf16)
        x[:, 12:] = 0                     # every expert's empty slots
        x[::7] = 0                        # experts that received no token
        wf = (torch.randn(E, K, N, device=dev, generator=gen) * 0.02).to(bf16)
        lib = lambda x=x, wf=wf: torch.bmm(x, wf)
        sx, sw = fused_scales(x, wf, 2)
        run(f"{name} dynamic", x, wf, sx, sw, 2, False, lib)
        leaf = _prequant_leaf(wf, 2)
        run(f"{name} packed", x, leaf["qkernel"], act_scale(x, 2), leaf["qscale"], 2,
            True, lib)
    for M2 in (64, 4):
        for name, K, N, bits in DS_GEMMS:
            x = torch.randn(M2, K, device=dev, generator=gen).to(bf16)
            wf = (torch.randn(K, N, device=dev, generator=gen) * 0.02).to(bf16)
            sx, sw = fused_scales(x, wf, bits)
            # library: torch._int_mm on the int8 operands where cuBLASLt
            # takes the shape (M=64; none at M=4)
            run(f"{name} dynamic", x, wf, sx, sw, bits, False,
                lib_int_mm(torch, *int8_operands(torch, x, wf, sx, sw, bits)))
    return records


def check_expert_int_gemm(torch, flush):
    """Rows 3 and 4 over the experts, as the unfused expert route calls them:
    one MoE layer's 3 expert GEMMs over deepseek-v2-lite's 64 experts at
    M=16 on int2 codes made by the route's own scales and quantizer;
    ``ops.matmul_int8`` with stats (dynamic: int8 carriers, memset + GEMM +
    ``tugemm_stats``) and ``ops.matmul_packed`` (prequant: int2 planes), each
    one launch a call over all experts (the counters), held to its plain
    version bit for bit; library ``torch.bmm`` on the bf16 operands. Their
    device time is read by the last phase. Returns the records."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.unary_stats import HDR
    from repro_torch.quant.quantize import fused_scales, quantize
    from repro_torch.quant.surgery import _prequant_leaf

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(10)
    E, M = MOE_EXPERTS, MOE_M
    records = []
    for name, K, N in MOE_GEMMS:
        x = torch.randn(E, M, K, device=dev, generator=gen).to(torch.bfloat16)
        x[:, 12:] = 0                     # every expert's empty slots
        x[::7] = 0                        # experts that received no token
        wf = (torch.randn(E, K, N, device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        sx, sw = fused_scales(x, wf, 2)
        xq, wq = quantize(x, sx.reshape(E, 1, 1), 2), quantize(wf, sw.unsqueeze(-2), 2)
        pb = _prequant_leaf(wf, 2)["qkernel"]
        lib = lambda x=x, wf=wf: torch.bmm(x, wf)
        cases = (
            ("tugemm_int8", "dynamic", wq, 1, {"tugemm_int8": 1, "tugemm_stats": 1},
             lambda impl, xq=xq, wq=wq: ops.matmul_int8(xq, wq, collect_stats=True, impl=impl)),
            ("tugemm_packed", "packed", pb, 4, {"tugemm_packed": 1},
             lambda impl, xq=xq, pb=pb: ops.matmul_packed(xq, pb, bits=2, impl=impl)))
        for kernel, form, w, planes, one_launch, fn in cases:
            before = ops.kernel_counts()
            got = fn("cuda")
            after = ops.kernel_counts()
            want = fn("torch")
            torch.cuda.synchronize()
            launches = {k: after[k]["launches"] - before[k]["launches"] for k in after}
            exact, err = _exact(got, want)
            stats = 4 * E * (2 * K + HDR + K) if kernel == "tugemm_int8" else 0
            call = lambda fn=fn: fn("cuda")
            rec = dict(kernel=kernel, case=f"{name} experts {form}", experts=E, M=M, K=K, N=N,
                       bits=2, stats=kernel == "tugemm_int8",
                       **gemm_grid(M, N, w.shape[-2], planes, 1, E),
                       exact=exact, max_abs_err=err, launches_a_call=launches,
                       ms=median_ms(torch, call, flush=flush),
                       plain_ms=median_ms(torch, lambda fn=fn: fn("torch"), flush=flush),
                       library_ms=median_ms(torch, lib, flush=flush),
                       **_bound(nbytes(xq, w) + 4 * E * M * N + stats, 2 * E * M * K * N))
            emit({"phase": "check_moe_gemm", **rec})
            if not exact:
                raise AssertionError(f"{kernel} over the experts disagrees with its plain "
                                     f"version: {rec}")
            if {k: n for k, n in launches.items() if n} != one_launch:
                raise AssertionError(f"{kernel} over the experts is not one launch a call: "
                                     f"{rec}")
            DEVICE_TIMED.append((rec, call, lib))
            records.append(rec)
    return records


# (model, GEMM, K, N) of the SSM and hybrid layers: falcon-mamba-7b's four
# SSM projections, hymba-1.5b's four at d_model 1600 (dt_rank 100, so
# ``ssm.dt`` has K = 100: a bf16 row of 200 bytes) and its attention and MLP
SSM_GEMMS = [("hymba-1.5b", "ssm.in_proj", 1600, 6400), ("hymba-1.5b", "ssm.x_proj", 3200, 132),
             ("hymba-1.5b", "ssm.dt", 100, 3200), ("hymba-1.5b", "ssm.out_proj", 3200, 1600),
             ("hymba-1.5b", "attn.k/v", 1600, 320), ("hymba-1.5b", "attn.q/o", 1600, 1600),
             ("hymba-1.5b", "mlp.gate/up", 1600, 5504), ("hymba-1.5b", "mlp.down", 5504, 1600),
             ("falcon-mamba-7b", "ssm.in_proj", 4096, 16384),
             ("falcon-mamba-7b", "ssm.x_proj", 8192, 288),
             ("falcon-mamba-7b", "ssm.dt", 256, 8192),
             ("falcon-mamba-7b", "ssm.out_proj", 8192, 4096)]
SSM_M = (4, 64, 128)          # decode (max_batch 4) and B=1 prefills of 64 and 128 tokens
LONG_PROMPT = 1100            # hymba's long request: its prefill's M


def check_ssm_gemm(torch, flush):
    """``tugemm_fused`` at the widths of the SSM and hybrid serves, none of
    which an earlier phase ran: ``ops.matmul_fused`` with stats, bf16 x and
    W quantized on load, int8 and int2, at M = 4, 64 and 128 (and 1,100 for
    hymba's ``ssm.in_proj``, the long prompt's prefill), each held to its
    plain version bit for bit, outputs and stats; ``torch._int_mm`` on the
    int8 operands as the library where cuBLASLt takes the shape (M > 16, K
    and N multiples of 8). Returns the records."""
    from repro_torch.quant.quantize import fused_scales

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(11)
    records = []
    for model, name, K, N in SSM_GEMMS:
        wf = (torch.randn(K, N, device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        long = (LONG_PROMPT,) if (model, name) == ("hymba-1.5b", "ssm.in_proj") else ()
        for M in SSM_M + long:
            x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            for bits in (8, 2):
                sx, sw = fused_scales(x, wf, bits)
                lib = lib_int_mm(torch, *int8_operands(torch, x, wf, sx, sw, bits))
                records.append(fused_case(torch, "check_ssm_gemm", f"{model} {name}", x, wf,
                                          sx, sw, bits, False, lib, flush, model=model))
    return records


# ------------------------------------------------------------ the C1 path
def layer0_weights(params) -> dict:
    """{GEMM name: layer 0's (K, N) weight} of the model's first group."""
    blk = params["groups"][0]["k0"]
    return {g[0]: blk[sect][w]["kernel"][0] for g, (sect, w) in zip(LAYER_GEMMS, LAYER_WEIGHTS)}


def layer0_activations(torch, K: int, M: int = 64, dtype=None):
    """A seeded (M, K) activation at the serve phase's batch."""
    gen = torch.Generator(device=DEVICE).manual_seed(5 + K + M)
    return torch.randn(M, K, device=DEVICE, generator=gen).to(dtype or torch.bfloat16)


def c1_operands(torch, params, bits_of=None, M: int = 64) -> list:
    """The seven layer-0 GEMMs' int8 operands, quantized by ``ops.quantize_sym``
    (activations per tensor, weights per column) at each GEMM's bits:
    [(name, a (M, K), b (K, N), bits)]."""
    from repro_torch.kernels import ops
    from repro_torch.quant.quantize import compute_scale

    ws = layer0_weights(params)
    out = []
    for name, _, _, bits in LAYER_GEMMS:
        bits = bits_of or bits
        w = ws[name]
        x = layer0_activations(torch, w.shape[0], M)
        a = ops.quantize_sym(x, compute_scale(x, bits), bitwidth=bits)
        b = ops.quantize_sym(w, compute_scale(w, bits, axis=1), bitwidth=bits)
        out.append((name, a, b, bits))
    return out


def check_c1(torch, flush, params):
    """``quantize_sym`` and ``temporal_unary_gemm`` against their plain
    versions, exactly, at the C1 path's full-width shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quantize import quantize_sym
    from repro_torch.kernels.temporal_unary import temporal_unary_gemm
    from repro_torch.kernels.tugemm_int8 import tugemm_int8
    from repro_torch.quant.quantize import compute_scale

    records = []

    def run(kernel, case, fn, plain, lib_ms, byts, n_ops, rate, **extra):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        exact = got.dtype == want.dtype and torch.equal(got, want)
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        rec = dict(kernel=kernel, case=case, **extra, exact=exact, max_abs_err=err,
                   ms=median_ms(torch, fn, flush=flush),
                   plain_ms=median_ms(torch, plain, flush=flush), library_ms=lib_ms,
                   **_bound(byts, n_ops, rate))
        emit({"phase": "check_c1", **rec})
        if not exact or err > C1_TOL:
            raise AssertionError(f"{kernel} disagrees with its plain version: {rec}")
        records.append(rec)

    # quantize_sym: no single PyTorch call computes clip(round(x * inv)) as
    # int8, so its library time is null. The kernel takes the scale as
    # given (its reciprocal in the launch), held against the plain version
    # given inv = 1/scale in f32; a bound counts x, q and the scale as given
    # (4 bytes per tensor or per number, 4N per column). The last phase
    # reads the device time of the serve policy's 14 operands (bf16, each
    # GEMM's bits) through ops.quantize_sym as c1_operands calls it, and of
    # the ragged and misaligned cases
    bits_of = {n: bits for n, _, _, bits in LAYER_GEMMS}
    ws = layer0_weights(params)
    inputs = [(f"{n}.weight", ws[n], True) for n, *_ in LAYER_GEMMS]
    inputs += [(f"{n}.act", layer0_activations(torch, ws[n].shape[0]), False)
               for n, *_ in LAYER_GEMMS]
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    ragged = torch.randn(37, 333, device=DEVICE, generator=gen) * 3
    inputs.append(("ragged", ragged, False))

    def misaligned(x0, dt):
        """x0 as dt, one element into an odd-sized buffer: its data pointer
        is off 16-byte alignment."""
        buf = torch.empty(x0.numel() + 1, dtype=dt, device=DEVICE)
        x = buf[1:].view(x0.shape)
        x.copy_(x0)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
        return x

    def quant(case, x, scale, bits, form, via=quantize_sym, timed=False, serve=False):
        M, N = x.shape
        s_bytes = 4 if form == "float" else nbytes(scale)
        call = lambda: via(x, scale, bitwidth=bits, impl="cuda")
        run("quantize_sym", case, call, lambda: via(x, scale, bitwidth=bits, impl="torch"),
            None, nbytes(x) + s_bytes + M * N, M * N, "f32", M=M, N=N, bits=bits,
            dtype=str(x.dtype).split(".")[-1], scale_form=form, scale_bytes=s_bytes,
            via=via.__module__.rsplit(".", 1)[-1] + ".quantize_sym", serve=serve)
        if timed:
            DEVICE_TIMED.append((records[-1], call, None))

    def scale_of(x, bits, per_col):
        s = compute_scale(x, bits, axis=1 if per_col else None)
        return s, "(N,)" if per_col else "0-d"

    # the kernel wrapper: every operand in bf16 and f32 at 2, 4 and 8 bits,
    # the scale as c1_operands gives it (0-d per tensor, (N,) per column)
    for case, x0, per_col in inputs:
        for dt in (torch.bfloat16, torch.float32):
            x = x0.to(dt).contiguous()
            for bits in (2, 4, 8):
                s, form = scale_of(x, bits, per_col)
                quant(case, x, s, bits, form, timed=case == "ragged" and bits == 8)
    for case, x0 in (("misaligned attn.q.weight", ws["attn.q"]), ("misaligned ragged", ragged)):
        for dt in (torch.bfloat16, torch.float32):
            x = misaligned(x0, dt)
            for per_col in (True, False):
                s, form = scale_of(x, 8, per_col)
                quant(case, x, s, 8, form, timed=dt == torch.bfloat16 and per_col)

    # ops.quantize_sym with each scale form on every serve operand in bf16
    # at its GEMM's bits, and on the ragged x per tensor and per column; the
    # form c1_operands passes (0-d, (N,)) is the serve operand's timed call
    for case, x0, per_col in inputs:
        bits = bits_of.get(case.rsplit(".", 1)[0], 8)
        x = x0.to(torch.bfloat16).contiguous()
        s = compute_scale(x, bits, axis=1 if per_col else None)
        forms = [("(N,)", s), ("(1, N)", s.reshape(1, -1))] if per_col else \
            [("0-d", s), ("float", s.item())]
        if case == "ragged":
            sc = compute_scale(x, bits, axis=1)
            forms += [("(N,)", sc), ("(1, N)", sc.reshape(1, -1))]
        for i, (form, scale) in enumerate(forms):
            first = i == 0 and case != "ragged"
            quant(case, x, scale, bits, form, via=ops.quantize_sym, timed=first, serve=first)

    def temporal(case, a, b, bits):
        from repro_torch.kernels.temporal_unary import BM, BN, split_plan

        M, K = a.shape
        N = b.shape[1]
        lib = lib_call = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:     # cuBLASLt's int8 product
            lib_call = lambda: torch._int_mm(a, b)
            lib = median_ms(torch, lib_call, flush=flush)
        int8 = median_ms(torch, lambda: tugemm_int8(a, b, impl="cuda"), flush=flush)
        call = lambda: temporal_unary_gemm(a, b, bitwidth=bits, impl="cuda")
        steps = 2 ** (bits - 1)
        _, ks, _, us = split_plan(M, N, K, steps, sms)
        run("temporal_unary_gemm", case, call,
            lambda: temporal_unary_gemm(a, b, bitwidth=bits, impl="torch"), lib,
            nbytes(a, b) + 4 * M * N, steps * 2 * M * K * N, "int8",
            M=M, K=K, N=N, bits=bits, unary_steps=steps, int8_kernel_ms=int8,
            blocks=-(-M // BM) * -(-N // BN) * ks * us)
        DEVICE_TIMED.append((records[-1], call, lib_call))

    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    for bits_of, label in ((None, "serve"), (4, "w4")):
        for name, a, b, bits in c1_operands(torch, params, bits_of):
            temporal(f"{name} {label}", a, b, bits)
    name, a, b, bits = c1_operands(torch, params, M=4)[0]
    temporal(f"{name} M=4", a, b, bits)
    gen = torch.Generator(device=DEVICE).manual_seed(7)

    def i8(shape, lo=-128, hi=128):
        t = torch.randint(lo, hi, shape, device=DEVICE, generator=gen, dtype=torch.int8)
        t.view(-1)[0] = lo            # the most negative code is in every operand
        return t

    temporal("ragged", i8((37, 333)), i8((333, 65)), 8)
    # N not a multiple of the kernel's 128 columns and K not a multiple of its
    # K tile of 64: 16-byte loads with masked tails (1040), then byte loads
    # (1000), at the serve batch and at decode
    for M in (64, 4):
        for KN in (1040, 1000):
            temporal(f"ragged tiles {M}x{KN}x{KN}", i8((M, KN)), i8((KN, KN)), 8)
    # one unary step: 1-bit A in [-1, 0]
    temporal("w=1", i8((64, 1024), -1, 1), i8((1024, 2048)), 1)
    # saturation: A spans all of int8 but the decomposition runs at 2 bits, so
    # it saturates |a| at 2; held against the plain GEMM of the saturated A
    a, b = i8((64, 1024)), i8((1024, 2048), -2, 2)
    sat = (a.to(torch.int32).sign() * a.to(torch.int32).abs().clamp_max(2)).to(torch.int8)
    run("temporal_unary_gemm", "saturation",
        lambda: temporal_unary_gemm(a, b, bitwidth=2, impl="cuda"),
        lambda: temporal_unary_gemm(sat, b, bitwidth=2, impl="torch"), None,
        nbytes(a, b) + 4 * 64 * 2048, 2 * 2 * 64 * 1024 * 2048, "int8",
        M=64, K=1024, N=2048, bits=2, unary_steps=2)
    return records


def c1_legs(torch, a, b, bits):
    """The four device legs on int8 operands a (M, K), b (K, N), each through
    its public entry point: (y int32, step cycles, serial, parallel) of
    ``core.tugemm``, after checking that the temporal kernel's, the int8
    kernel's and the fused kernel's (unit scales, f32 out) products and the
    int8 kernel's and the fused kernel's stats equal it exactly."""
    from repro_torch.core import tugemm
    from repro_torch.kernels import ops

    N = b.shape[1]
    y, st = tugemm(a, b)
    y_u = ops.temporal_gemm(a, b, bitwidth=bits)
    y_i, st_i = ops.matmul_int8(a, b, collect_stats=True)
    y_f, st_f = ops.matmul_fused(a.float(), b.float(), sx=torch.tensor(1.0, device=a.device),
                                 sw=torch.ones(N, device=a.device), bits=bits,
                                 collect_stats=True, out_dtype=torch.float32)
    same = torch.equal(y_u, y) and torch.equal(y_i, y) and torch.equal(y_f, y.float())
    for s in (st_i, st_f):
        same &= (torch.equal(s.step_cycles, st.step_cycles)
                 and int(s.serial_cycles) == int(st.serial_cycles)
                 and int(s.parallel_cycles) == int(st.parallel_cycles))
    if not same:
        raise AssertionError(f"C1 legs disagree on a {tuple(a.shape)} x {tuple(b.shape)} "
                             f"GEMM at {bits} bits")
    return y, st.step_cycles, int(st.serial_cycles), int(st.parallel_cycles)


def c1_agree(torch, case: str, A, B, bits: int, sim: str | None) -> dict:
    """Exact agreement of the legs (and the gate-level simulator when ``sim``
    names its variant) on numpy operands A, B; returns the phase record."""
    import numpy as np

    from repro_torch.core.cycle_sim import simulate_parallel, simulate_serial

    dev = torch.device(DEVICE)
    a = torch.from_numpy(A.astype(np.int8)).to(dev)
    b = torch.from_numpy(B.astype(np.int8)).to(dev)
    y0, sc0, ser0, par0 = c1_legs(torch, a, b, bits)
    exact = A.astype(np.int64) @ B.astype(np.int64)
    rec = {"phase": "c1_validation", "case": case, "bits": bits, "shape": list(A.shape) +
           [B.shape[1]], "serial_cycles": ser0, "parallel_cycles": par0}
    ok = np.array_equal(y0.cpu().numpy(), exact)
    ok &= ser0 == int(sc0.sum()) and par0 == int(sc0.max())
    if sim is not None:
        t0 = time.perf_counter()
        r = (simulate_serial if sim == "serial" else simulate_parallel)(A, B)
        rec.update(sim=sim, sim_cycles=r.total_cycles, sim_s=time.perf_counter() - t0)
        ok &= np.array_equal(r.Y, exact) and np.array_equal(r.step_cycles, sc0.cpu().numpy())
        ok &= r.total_cycles == (ser0 if sim == "serial" else par0)
    rec["agree"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError(f"C1 conformance failed: {rec}")
    return rec


def c1_validation(torch, params) -> dict:
    """The C1 conformance on the 12 Table I design points (numpy seed 0), the
    paper's corners, and the seven full-width layer-0 GEMMs (no simulator:
    it is a numpy loop over every cycle)."""
    import numpy as np

    from repro_torch.configs.tugemm_paper import HW_CONFIGS
    from repro_torch.core import int_range, max_magnitude, worst_case_cycles

    totals = {"serial_cycles": 0, "parallel_cycles": 0}
    for name, hw in HW_CONFIGS.items():
        rng = np.random.default_rng(0)
        lo, hi = int_range(hw.bitwidth)
        A = rng.integers(lo, hi + 1, (hw.m, hw.n))
        B = rng.integers(lo, hi + 1, (hw.n, hw.p))
        c1_agree(torch, name, A, B, hw.bitwidth, hw.variant)
    for bits in (2, 4, 8):
        rng = np.random.default_rng(20 + bits)
        lo, hi = int_range(bits)
        A = rng.integers(lo, hi + 1, (16, 16))
        B = rng.integers(lo, hi + 1, (16, 16))
        A[:, 1] = np.where(A[:, 1] == 0, 1, A[:, 1])
        B[1, :] = 0
        r = c1_agree(torch, f"zero B row w={bits}", A, B, bits, "serial")
        B = rng.integers(lo, hi + 1, (16, 16))
        A[:, 2] = 0
        c1_agree(torch, f"zero A column w={bits}", A, B, bits, "serial")
        m = max_magnitude(bits)
        A = np.full((16, 16), -m)
        B = np.full((16, 16), -m)
        B[:, 1] = m - 1 if bits > 2 else -m
        A[1, :] = m - 1 if bits > 2 else -m
        r = c1_agree(torch, f"worst case w={bits}", A, B, bits, "serial")
        if (r["serial_cycles"], r["parallel_cycles"]) != (worst_case_cycles(bits, 16, "serial"),
                                                          worst_case_cycles(bits, 16, "parallel")):
            raise AssertionError(f"the worst case missed worst_case_cycles: {r}")
    for name, a, b, bits in c1_operands(torch, params):
        _, _, ser, par = c1_legs(torch, a, b, bits)    # raises unless all four agree
        emit({"phase": "c1_validation", "case": f"layer0 {name}", "bits": bits,
              "shape": [a.shape[0], a.shape[1], b.shape[1]], "serial_cycles": ser,
              "parallel_cycles": par, "agree": True})
        totals["serial_cycles"] += ser
        totals["parallel_cycles"] += par
    return totals


def run_quickstart(torch) -> dict:
    """``repro_torch.quickstart.main`` at full width on the card, then its
    forward again through the plain versions. Attention is the one kernel
    of that forward that sums in another order than its plain version (in
    f32), and an int8 code downstream that rounds the other way moves the
    cycle totals, so both pairs of totals are printed."""
    from repro_torch import quickstart
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    out = quickstart.main(arch=ARCH, device=DEVICE)
    torch.cuda.synchronize()
    counts = ops.kernel_counts()
    s4 = out["step4"]
    seconds = time.perf_counter() - t0
    plain = quickstart.main(arch=ARCH, device=DEVICE, impl="torch")["step4"]
    emit({"phase": "quickstart", "arch": s4["arch"], "seconds": seconds,
          "step1": out["step1"], "step3": out["step3"], "gemms": s4["gemms"],
          "expected_max": s4["expected_max"], "serial_cycles": s4["serial_cycles"],
          "parallel_cycles": s4["parallel_cycles"], "plain_serial_cycles": plain["serial_cycles"],
          "plain_parallel_cycles": plain["parallel_cycles"],
          "speedup_vs_worst": s4["speedup_vs_worst"],
          "energy": s4["energy_render_total"], "energy_total_j": s4["energy_total_j"],
          "kernel_counts": counts})
    if counts["tugemm_fused"]["launches"] <= 0 or any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"the quickstart forward did not run only kernels: {counts}")
    if s4["gemms"] != len(LAYER_GEMMS) * get_config(ARCH).num_layers:
        raise AssertionError(f"the quickstart forward recorded {s4['gemms']} GEMMs")
    return out


# ------------------------------------------------------------- model phases
def model_setup(torch):
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.models import init

    cfg = get_config(ARCH)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", quant_policy=POLICY,
                   kv_cache_dtype="int8", kv_layout="paged", block_size=16,
                   prefill_chunk=16)
    t0 = time.perf_counter()
    params = init(cfg, rc, torch.Generator().manual_seed(0), device=DEVICE)
    torch.cuda.synchronize()
    return cfg, rc, params, time.perf_counter() - t0


def model_setup_moe(torch):
    """deepseek-v2-lite at full width (``MOE_LAYERS`` layers, 27 uncut), bf16
    weights drawn on the card from a CUDA ``torch.Generator`` seeded 0, under
    the fused dynamic MoE policy."""
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.models import init

    cfg = get_config(MOE_ARCH)
    if MOE_LAYERS is not None:
        cfg = cfg.replace(num_layers=MOE_LAYERS)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", quant_policy=MOE_POLICY,
                   kv_cache_dtype="int8", kv_layout="paged", block_size=16,
                   prefill_chunk=16)
    t0 = time.perf_counter()
    params = init(cfg, rc, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    torch.cuda.synchronize()
    return cfg, rc, params, time.perf_counter() - t0


def surgered(cfg, rc, params, policy: str):
    """The RunConfig under ``policy`` and the params after its surgery
    (prequant leaves packed offline; the float tree is left as it is)."""
    import dataclasses

    from repro_torch.quant import apply_surgery

    rc = dataclasses.replace(rc, quant_policy=policy)
    return rc, apply_surgery(cfg, rc, params)


def _mixed_ticks(torch, cfg, rc, params, impl: str, forced: list | None = None):
    """One prefill tick (rows of 16, 16, 9 and 0 tokens) and one decode tick
    of the mixed step through ``impl``; ``forced`` routes each MoE call by
    another run's expert choices (``moe.routing``). Returns (prefill logits,
    decode logits, live rows, each MoE call's top-k expert ids in call
    order)."""
    from repro_torch.models import init_caches, moe
    from repro_torch.serve.cache import BlockManager
    from repro_torch.serve.scheduler import build_mixed_step

    dev = torch.device(DEVICE)
    B, W, cap = 4, rc.prefill_chunk, 256
    mgr = BlockManager(B * cap // rc.block_size, rc.block_size, B, cap)
    rng = torch.Generator().manual_seed(3)
    lens = torch.tensor([16, 16, 9, 0], dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B, W), generator=rng, dtype=torch.int32)
    for b in range(B):
        mgr.extend(b, int(lens[b]) + 1)          # room for the decode tick too
    tables = torch.from_numpy(mgr.tables.copy()).to(dev)
    with moe.routing(forced) as routed:
        caches = init_caches(cfg, rc, B, cap, num_pages=mgr.num_pages, device=dev)
        step = build_mixed_step(cfg, rc, with_stats=True, impl=impl)
        pos = torch.zeros(B, dtype=torch.int32)
        caches, l1, _ = step(params, caches, tokens.to(dev), pos.to(dev), lens.to(dev), tables)
        dec = torch.zeros((B, 1), dtype=torch.int32)
        dec[:, 0] = torch.tensor([11, 22, 33, 0])
        dlens = (lens > 0).to(torch.int32)
        caches, l2, _ = step(params, caches, dec.to(dev), lens.to(dev), dlens.to(dev), tables)
    live = (lens > 0).nonzero().flatten().tolist()
    return l1.float()[live], l2.float()[live], live, routed


def _logit_parity(cfg, got, want, rec: dict, prefix: str = "") -> None:
    """rel L2, max abs and argmax agreement of two paths' (prefill, decode)
    logits into ``rec``; raises unless ``got`` is finite of shape (rows, vocab)."""
    for name, a, b in (("prefill", got[0], want[0]), ("decode", got[1], want[1])):
        if not (a.isfinite().all() and a.shape == (len(got[2]), cfg.vocab_size)):
            raise AssertionError(f"{name} logits are not finite of shape (rows, vocab)")
        rec[f"{prefix}{name}_rel_l2"] = ((a - b).norm() / b.norm()).item()
        rec[f"{prefix}{name}_max_abs"] = (a - b).abs().max().item()
        rec[f"{prefix}{name}_argmax_agree"] = int((a.argmax(-1) == b.argmax(-1)).sum())
        rec[f"{prefix}{name}_rows"] = len(got[2])


def step_parity(torch, cfg, rc, params, phase: str = "step_parity"):
    """One prefill and one decode tick through the kernels and through the
    plain versions, logits within ``STEP_REL_TOL`` relative L2."""
    got = _mixed_ticks(torch, cfg, rc, params, "cuda")
    want = _mixed_ticks(torch, cfg, rc, params, "torch")
    rec = {"phase": phase, "policy": rc.quant_policy, "tol_rel_l2": STEP_REL_TOL,
           "layers": cfg.num_layers}
    _logit_parity(cfg, got, want, rec)
    emit(rec)
    if rec["prefill_rel_l2"] > STEP_REL_TOL or rec["decode_rel_l2"] > STEP_REL_TOL:
        raise AssertionError(f"mixed step: kernels vs plain versions beyond tolerance: {rec}")


def _pinned(rc, impl: str):
    """``rc`` with every quantized rule of its policy pinned to ``impl``
    (a rule's own impl overrides the step's)."""
    import dataclasses

    rules = [r if r.endswith("=bf16") else f"{r}:{impl}" for r in rc.quant_policy.split(",")]
    return dataclasses.replace(rc, quant_policy=",".join(rules))


def step_parity_moe(torch, cfg, rc, params, phase: str = "step_parity_moe"):
    """A model's mixed step through the kernels (the MoE models', and
    qwen2-vl's: any whose all-plain step an int2 policy moves past the
    tolerance), held against the plain versions in two gated parts that
    together cover every kernel of the step: (a) every GEMM and stats kernel's plain version with attention
    on its kernel (its rules pinned to ``torch``): router choices identical
    and logits within ``STEP_REL_TOL`` (the fused GEMMs hold their plain
    versions bit for bit, so both are exact); (b) under ``*=bf16`` (no
    quantized GEMM), attention's kernel against its plain version at full
    depth, the plain run routed by the kernel run's expert choices
    (``moe.routing``): logits within ``STEP_REL_TOL``. The policy's all-plain
    step, routed by the kernel run's choices and freely, is printed only:
    its int2 GEMMs turn attention's one-ulp summation-order differences into
    a 14-58% logit distance at 27 layers, as far as random one-ulp nudges of
    the plain attention do (``scripts/moe_parity_probe.py``)."""
    import dataclasses

    from repro_torch.kernels import ops

    got = _mixed_ticks(torch, cfg, rc, params, "cuda")
    ops.reset_counts()
    want = _mixed_ticks(torch, cfg, _pinned(rc, "torch"), params, "cuda")
    pinned_paths = ops.path_counts()
    rc16 = dataclasses.replace(rc, quant_policy="*=bf16")
    got16 = _mixed_ticks(torch, cfg, rc16, params, "cuda")
    ops.reset_counts()
    plain16 = _mixed_ticks(torch, cfg, rc16, params, "torch", forced=got16[3])
    forced = _mixed_ticks(torch, cfg, rc, params, "torch", forced=got[3])
    plain_paths = ops.path_counts()
    free = _mixed_ticks(torch, cfg, rc, params, "torch")
    rec = {"phase": phase, "policy": rc.quant_policy, "tol_rel_l2": STEP_REL_TOL,
           "layers": cfg.num_layers, "router_calls": len(got[3]),
           "router_identical": len(got[3]) == len(want[3]) and all(
               torch.equal(a, b) for a, b in zip(got[3], want[3]))}
    _logit_parity(cfg, got, want, rec)
    _logit_parity(cfg, got16, plain16, rec, "bf16_attention_")
    _logit_parity(cfg, got, forced, rec, "all_plain_forced_")
    _logit_parity(cfg, got, free, rec, "all_plain_free_")
    rec["pinned_paths"], rec["plain_paths"] = pinned_paths, plain_paths
    rec["all_plain_free_router_tokens_same_choices"] = [
        int((a == b).all(-1).sum()) for a, b in zip(got[3], free[3])]
    rec["router_tokens"] = [int(a.shape[0] * a.shape[1]) for a in got[3]]
    emit(rec)
    if any(set(p) != {"torch"} for p in plain_paths.values()) or any(
            set(p) != {"cuda" if n.endswith(".paged") else "torch"}
            for n, p in pinned_paths.items()):
        raise AssertionError(f"the plain MoE steps ran the wrong routes: {pinned_paths} "
                             f"{plain_paths}")
    worst = max(rec[f"{pre}{t}_rel_l2"] for pre in ("", "bf16_attention_")
                for t in ("prefill", "decode"))
    if not rec["router_identical"] or worst > STEP_REL_TOL:
        raise AssertionError(f"MoE mixed step: kernels vs plain versions beyond tolerance or "
                             f"router choices differ: {rec}")


def serving_scheduler(cfg, rc, params, impl: str, *, requests: int = 8, **kw):
    """The serve phase's workload: a Scheduler holding ``requests`` requests
    of 32-128 prompt tokens from a seeded rng, 16 new tokens each. ``kw``
    goes to the Scheduler (``faults``, ``tracer``, ``metrics``)."""
    import numpy as np

    from repro_torch.serve import Request, Scheduler

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(32, 129))).tolist()
               for _ in range(requests)]
    sched = Scheduler(cfg, rc, params, capacity=256, max_batch=4, track_energy=True,
                      device=DEVICE, impl=impl, **kw)
    for rid, p in enumerate(prompts):
        if sched.submit(Request(rid=rid, prompt=p, max_new=16)) is not None:
            raise AssertionError(f"request {rid} refused at submit")
    return sched, prompts


def serve(torch, cfg, rc, params, impl: str, **kw):
    from repro_torch.kernels import ops

    sched, prompts = serving_scheduler(cfg, rc, params, impl, **kw)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.kernel_counts()
    graphed_gate(sched)
    return sched, done, wall, counts, prompts


def graphed_gate(sched) -> None:
    """A one-card Scheduler (no mesh, ``graphs`` not turned off) ran its
    mixed, verify and draft steps as CUDA graphs: one eager call a step and
    width (the warm call before the capture), replays after it; only the
    fallback step runs eagerly more than once."""
    if sched.mesh is not None or not sched.graphs:
        return
    counts = {k: v for k, v in sched.step_counts().items() if k != "fallback"}
    calls = [c for r in counts.values() for c in r.values()]
    if not calls or any(c["eager"] != 1 for c in calls) or not any(c["replays"] for c in calls):
        raise AssertionError(f"a one-card serve did not replay its steps as graphs: "
                             f"{sched.step_counts()}")


def step_record(sched) -> dict:
    """Each step's eager calls and graph replays a width, with each graph's
    capture ms and the bytes its capture reserved in the Scheduler's pool."""
    counts = sched.step_counts()
    calls = [c for r in counts.values() for c in r.values()]
    return {"step_counts": counts, "graph_replays": sum(c["replays"] for c in calls),
            "eager_step_calls": sum(c["eager"] for c in calls),
            "graph_pool_bytes": sum(c.get("pool_bytes", 0) for c in calls),
            "capture_ms": sum(c.get("capture_ms", 0.0) for c in calls)}


def check_served(cfg, sched, done, prompts, bits: set) -> dict:
    """Every request finished with 16 in-vocabulary tokens and cycle totals
    at exactly ``bits``; returns {rid: tokens}."""
    outs = {r.rid: list(r.out) for r in done}
    if sorted(outs) != list(range(len(prompts))) or any(len(o) != 16 for o in outs.values()):
        raise AssertionError(f"not every request finished with 16 tokens: {outs}")
    if any(not 0 <= t < cfg.vocab_size for o in outs.values() for t in o):
        raise AssertionError("a token outside the vocabulary")
    energy = sched.energy_summary()
    if any(e["cycles"] <= 0 or set(e["cycles_by_bits"]) != bits for e in energy):
        raise AssertionError(f"cycle totals missing: {energy}")
    return outs


def serve_record(phase, sched, done, wall, counts, prompts) -> dict:
    from repro_torch.kernels import ops

    gen = sum(len(r.out) for r in done)
    launches = sum(c["launches"] for c in counts.values())
    return {"phase": phase, "policy": sched.rc.quant_policy, "requests": len(done),
            "generated_tokens": gen, "prompt_tokens": sum(len(p) for p in prompts),
            "wall_s": wall, "tokens_per_s": gen / wall, "ticks": sched.ticks,
            "median_tick_ms": statistics.median(sched.tick_seconds) * 1e3,
            "kernel_launches_per_tick": launches / sched.ticks,
            "preemptions": sched.preemptions, "kernel_counts": counts,
            "paths": ops.path_counts(), "cycles_by_bits": {
                str(b): d for b, d in sorted(sched.cycles_by_bits.items())},
            "layers": sched.cfg.num_layers, **step_record(sched),
            **({"dropped_tokens_per_tick": statistics.mean(sched.tick_dropped_tokens),
                "dropped_tokens": sum(sched.tick_dropped_tokens),
                "moe_dropped_tokens": sched.moe_dropped_tokens}
               if sched.tick_dropped_tokens else {})}


# ------------------------------------------------- the compiled serving steps
GRAPH_REQUESTS = 4             # one wave of the serve phase's requests a leg


def serve_graphs(torch, leg: str, cfg, rc, params, bits: set) -> dict:
    """One leg of ``serve_graphs``: the first ``GRAPH_REQUESTS`` of the
    serve phase's requests through the eager step (``graphs=False``), then
    through the CUDA graphs (``serve/graphs.py``), counts zeroed just
    before each and read just after. Gate: tokens, KV lengths,
    ``cycles_by_bits`` (each request's, target and draft, and the totals),
    the MoE drops a tick, the kernel counts and the call sites' paths
    identical; the graphed serve replayed. Prints each serve's tick p50,
    tokens/s, wrapper launches a tick and, graphed, capture ms and pool
    bytes a width."""
    from repro_torch.kernels import ops

    runs = {}
    for mode in ("eager", "graphed"):
        sched, done, wall, counts, prompts = serve(torch, cfg, rc, params, "auto",
                                                   requests=GRAPH_REQUESTS,
                                                   graphs=mode == "graphed")
        paths = ops.path_counts()
        runs[mode] = (sched, check_served(cfg, sched, done, prompts, bits), counts, paths,
                      serve_record(f"serve_graphs {leg} {mode}", sched, done, wall, counts,
                                   prompts))
    (es, eo, ec, ep, er), (gs, go, gc, gp, gr) = runs["eager"], runs["graphed"]
    energy = lambda s: [(e["cycles_by_bits"], e.get("draft_cycles_by_bits"))
                        for e in s.energy_summary()]
    same = {"tokens": go == eo, "final_kv_lens": gs.final_kv_lens == es.final_kv_lens,
            "cycles_by_bits": gs.cycles_by_bits == es.cycles_by_bits,
            "request_cycles_by_bits": energy(gs) == energy(es),
            "dropped_tokens": gs.tick_dropped_tokens == es.tick_dropped_tokens,
            "kernel_counts": gc == ec, "paths": gp == ep,
            "drafted_accepted": (gs.drafted_tokens, gs.accepted_draft_tokens)
            == (es.drafted_tokens, es.accepted_draft_tokens)}
    keys = ("wall_s", "tokens_per_s", "ticks", "median_tick_ms", "kernel_launches_per_tick",
            "graph_replays", "eager_step_calls", "graph_pool_bytes", "capture_ms")
    rec = {"phase": "serve_graphs", "leg": leg, "arch": cfg.name, "layers": cfg.num_layers,
           "policy": rc.quant_policy, "spec_gamma": rc.spec_gamma,
           "requests": GRAPH_REQUESTS, "equal": same,
           **{mode: {k: r[4][k] for k in keys} for mode, r in runs.items()},
           "step_counts": gr["step_counts"], "cycles_by_bits": gr["cycles_by_bits"],
           "tick_ms_p50_ratio": gr["median_tick_ms"] / er["median_tick_ms"]}
    if gs.tick_dropped_tokens:
        rec["dropped_tokens"] = sum(gs.tick_dropped_tokens)
    emit(rec)
    if not all(same.values()) or not gr["graph_replays"] or er["graph_replays"]:
        raise AssertionError(f"serve_graphs {leg}: the graphed serve differs from the eager "
                             f"one, or did not replay: {rec}")
    return rec


# ------------------------------------------- serving robustness and observability
# The chaos and fallback phases compare runs whose schedules differ (a fault
# moves rows to other ticks). Per-token activation scales keep each row's
# numbers independent of the rows it is batched with, as the reference's
# chaos suite's unquantized policy does; under per-tensor scales another
# schedule is another computation.
ROBUST_POLICY = "attn.*=int8:per_token,mlp.*=int2:per_token,*=bf16"
CHAOS_RATES = {"alloc_fail": 0.35, "preempt_storm": 0.1, "nan_logits": 0.12}
# the health() counters the robustness phases print
HEALTH_COUNTERS = ("clock", "ticks", "preemptions", "stalled_rows_total", "stall_episodes",
                   "engine_stalls", "idle_fault_ticks", "nan_events", "fallback_retries",
                   "sheds", "submitted", "admitted", "completed", "deadline_misses")
FUSED_KERNELS = ("tugemm_fused", "flash_paged_decode", "tugemm_stats")


def _only_fused_on_cuda(phase: str, counts: dict, paths: dict) -> None:
    """A serve under the fused policy launched exactly the fused GEMM, its
    stats assembly and attention, made no plain call, and every call site
    took the ``cuda`` route."""
    ran = {k for k, c in counts.items() if c["launches"] > 0}
    routes = {path for p in paths.values() for path in p}
    if ran != set(FUSED_KERNELS) or any(c["plain_calls"] for c in counts.values()) \
            or routes != {"cuda"}:
        raise AssertionError(f"{phase} did not run only the fused kernels on the cuda route: "
                             f"{counts} {paths}")


def _pool_clean(phase: str, sched, done, n: int) -> None:
    sched.mgr.check_invariants()
    if sched.mgr.pages_in_use or sched.engine_stalls or len(done) != n \
            or not all(r.done for r in done):
        raise AssertionError(f"{phase}: pages leaked, the engine stalled or a request did "
                             f"not finish: {sched.health()}")


def serve_chaos(torch, cfg, rc, params):
    """The serve under ``ROBUST_POLICY``, fault-free, then under a generated
    ``FaultPlan`` (allocation failures, preemption storms, transient NaN
    logits, seed 0): the same greedy tokens, no page leaked, every request
    done, the faults exercised and no row escalated to the fallback step.
    Returns the fault-free run (scheduler, tokens, rid 0's finish tick)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.serve import FaultPlan

    rc_pt = dataclasses.replace(rc, quant_policy=ROBUST_POLICY)
    base, prompts = serving_scheduler(cfg, rc_pt, params, "auto")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid0_done = None
    while base.tick() or base.queue:
        if rid0_done is None and any(r.rid == 0 for r in base.finished):
            rid0_done = base.clock
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    want = check_served(cfg, base, base.finished, prompts, {8, 2})
    plan = FaultPlan.generate(0, horizon=8 * base.ticks + 50, max_batch=4, rates=CHAOS_RATES)
    sched, done, wall, counts, _ = serve(torch, cfg, rc_pt, params, "auto", faults=plan)
    paths = ops.path_counts()
    got = {r.rid: list(r.out) for r in done}
    h = sched.health()
    rec = {"phase": "serve_chaos", "policy": ROBUST_POLICY, "plan": plan.describe(),
           "rates": CHAOS_RATES, "fault_free_ticks": base.ticks, "fault_free_wall_s": wall_b,
           "wall_s": wall, "tokens": sum(len(v) for v in want.values()),
           "tokens_equal": sum(a == b for r in want for a, b in zip(want[r], got.get(r, []))),
           **{k: h[k] for k in HEALTH_COUNTERS},
           "injected_alloc_failures": sched.mgr.injected_failures,
           "ladder_transitions": len(h["ladder"]["transitions"]),
           "ladder_occupancy": h["ladder"]["occupancy"], "kernel_counts": counts,
           "paths": paths}
    emit(rec)
    _pool_clean("serve_chaos", sched, done, len(prompts))
    if got != want:
        raise AssertionError("serve_chaos: faults changed greedy tokens")
    if sched.mgr.injected_failures + sched.preemptions + sched.nan_events <= 0 \
            or sched.fallback_retries:
        raise AssertionError(f"serve_chaos: no fault fired, or a transient one escalated: {rec}")
    _only_fused_on_cuda("serve_chaos", counts, paths)
    return base, want, rid0_done


def serve_fallback(torch, cfg, rc, params, want, rid0_done: int):
    """A persistent NaN on row 0 (one ``nan_logits`` event a tick while rid 0,
    admitted there first, holds it in the fault-free run): rid 0 is retried
    once, then moves to the ``*=bf16`` fallback step, which runs on the card
    (attention's kernel on the ``cuda`` route; the GEMMs bf16
    ``torch.matmul``: no GEMM kernel launch, no quantized call site), and
    completes; the other requests' tokens equal the fault-free run's."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.serve import FaultEvent, FaultPlan

    rc_pt = dataclasses.replace(rc, quant_policy=ROBUST_POLICY)
    plan = FaultPlan([FaultEvent(t, "nan_logits", 0) for t in range(1, rid0_done + 1)])
    sched, prompts = serving_scheduler(cfg, rc_pt, params, "auto", faults=plan)
    fb_calls = []
    run_fb = sched._run_fallback

    def counted(*a, **k):       # each fallback step's own launches and call sites
        base = ops.kernel_counters()
        out = run_fb(*a, **k)
        torch.cuda.synchronize()
        fb_calls.append(ops.kernel_counters_since(base))
        return out

    sched._run_fallback = counted
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {r.rid: list(r.out) for r in done}
    launches = {}
    for c in fb_calls:
        for k, v in c["kernels"].items():
            launches[k] = launches.get(k, 0) + v.get("launches", 0)
    fb_paths = {}
    for c in fb_calls:
        for name, by in c["paths"].items():
            for path, n in by.items():
                fb_paths.setdefault(name, {}).setdefault(path, 0)
                fb_paths[name][path] += n
    h = sched.health()
    rec = {"phase": "serve_fallback", "policy": ROBUST_POLICY,
           "fallback_policy": sched.rc.fallback_policy, "nan_events_planned": len(plan),
           "fallback_steps": len(fb_calls), "fallback_launches": launches,
           "fallback_paths": fb_paths, "wall_s": wall,
           "rid0_tokens": len(got.get(0, [])),
           "others_tokens_equal": sum(a == b for r in want if r != 0
                                      for a, b in zip(want[r], got.get(r, []))),
           "others_tokens": sum(len(v) for r, v in want.items() if r != 0),
           **{k: h[k] for k in HEALTH_COUNTERS}, "kernel_counts": ops.kernel_counts(),
           "paths": ops.path_counts()}
    emit(rec)
    _pool_clean("serve_fallback", sched, done, len(prompts))
    if sched.fallback_retries < 1 or not fb_calls or len(got.get(0, [])) != 16:
        raise AssertionError(f"serve_fallback: rid 0 did not escalate and complete: {rec}")
    if fb_paths != {"attn.paged": {"cuda": cfg.num_layers * len(fb_calls)}} \
            or launches.get("flash_paged_decode", 0) < cfg.num_layers * len(fb_calls) \
            or any(launches.get(k, 0) for k in launches if k != "flash_paged_decode") \
            or any(v.get("plain_calls", 0) for c in fb_calls for v in c["kernels"].values()):
        raise AssertionError(f"serve_fallback: the fallback step did not run attention on "
                             f"its kernel and the GEMMs as bf16 matmuls: {rec}")
    if any(got.get(r) != want[r] for r in want if r != 0):
        raise AssertionError("serve_fallback: the other requests' tokens changed")


def serve_overload(torch, cfg, rc, params):
    """Bounded class queues under a burst: ``AdmissionController(max_queue=2)``
    with per-class TTLs and two tenants' budgets, 3 requests a tick for 10
    ticks (realtime / interactive / batch in turn) into 4 rows. The queues
    sit at their bound long enough for the ladder to climb one level a tick
    to ``shed`` (and ``reject``); after the burst it relaxes to
    ``healthy``. Every request ends done or with a structured rejection."""
    import numpy as np

    from repro_torch.serve import AdmissionController, RejectReason, Request, Scheduler

    adm = AdmissionController(max_queue=2, tenant_budgets={"acme": 700, "zeta": 350},
                              default_ttl={"interactive": 60, "batch": 12})
    sched = Scheduler(cfg, rc, params, capacity=256, max_batch=4, track_energy=True,
                      device=DEVICE, admission=adm)
    rng = np.random.default_rng(2)
    pri = ("realtime", "interactive", "batch")
    reqs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        for _ in range(3):
            rid = len(reqs)
            r = Request(rid=rid, max_new=16, priority=pri[rid % 3], tenant=("acme", "zeta")[rid % 2],
                        prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(32, 129))).tolist())
            reqs.append(r)
            sched.submit(r)
        sched.tick()
    sched.run()
    relax = 0
    while sched.ladder.level and relax < 64:   # idle ticks after the burst
        sched.tick()
        relax += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = sched.health()
    levels = {t["to"] for t in h["ladder"]["transitions"]}
    rec = {"phase": "serve_overload", "policy": rc.quant_policy, "requests": len(reqs),
           "done": sum(r.done for r in reqs), "rejections": h["rejections"],
           "tenant_spent": dict(adm.tenant_spent), "ladder_levels": sorted(levels),
           "ladder_final": h["ladder"]["name"], "ladder_occupancy": h["ladder"]["occupancy"],
           "idle_ticks_to_healthy": relax, "wall_s": wall,
           "generated_tokens": sum(len(r.out) for r in reqs), **step_record(sched),
           **{k: h[k] for k in HEALTH_COUNTERS}}
    emit(rec)
    sched.mgr.check_invariants()
    bad = [r.rid for r in reqs if not (r.done or (r.rejected is not None
                                                   and r.rejected.reason in RejectReason.ALL))]
    if bad or sched.mgr.pages_in_use or sched.engine_stalls:
        raise AssertionError(f"serve_overload: requests {bad} ended without a terminal state, "
                             f"or pages leaked: {rec}")
    if "shed" not in levels or h["ladder"]["level"] != 0:
        raise AssertionError(f"serve_overload: the ladder did not reach shed and relax: {rec}")
    graphed_gate(sched)
    if any(r.done and len(r.out) != 16 for r in reqs):
        raise AssertionError("serve_overload: a completed request lacks tokens")


# ------------------------------------------- prefix caching and speculative decoding
# The slice's phases serve under ROBUST_POLICY: per-token scales make a
# verify column's GEMMs compute what a decode column's do, so greedy
# speculative decoding is held to the plain serve's tokens exactly.
SPEC_GAMMA = 4
# the speculative serves: one wave of 4 requests, against their own plain
# serve (4 of the 8 requests, for the script's time limit)
SPEC_REQUESTS = 4
PREFIX_NEW = 8                 # new tokens a request of the shared-prompt trace


def _cycles_split(sched) -> tuple[dict, dict]:
    """(target, draft) cycles by bits summed over the requests' meters."""
    tgt, drf = {}, {}
    for e in sched.energy_summary():
        d = e.get("draft_cycles_by_bits", {})
        for b, c in e["cycles_by_bits"].items():
            tgt[str(b)] = tgt.get(str(b), 0) + c - d.get(b, 0)
        for b, c in d.items():
            drf[str(b)] = drf.get(str(b), 0) + c
    return tgt, drf


def _margin(torch, cfg, rc, params, seq) -> float:
    """The top-2 logit margin of the next token after ``seq``: one plain
    prefill step of the whole sequence into fresh pools (kernels on)."""
    from repro_torch.models import init_caches
    from repro_torch.serve.cache import BlockManager
    from repro_torch.serve.scheduler import build_mixed_step

    dev = torch.device(DEVICE)
    mgr = BlockManager(256 // rc.block_size, rc.block_size, 1, 256)
    mgr.extend(0, len(seq))
    caches = init_caches(cfg, rc, 1, 256, num_pages=mgr.num_pages, device=dev)
    step = build_mixed_step(cfg, rc)
    toks = torch.tensor([seq], dtype=torch.int32, device=dev)
    _, lg = step(params, caches, toks, torch.zeros(1, dtype=torch.int32, device=dev),
                 torch.tensor([len(seq)], dtype=torch.int32, device=dev),
                 torch.from_numpy(mgr.tables.copy()).to(dev))
    top = lg[0].float().topk(2).values
    return (top[0] - top[1]).item()


def spec_reference(torch, cfg, rc, params):
    """The plain ``ROBUST_POLICY`` serve of the first ``SPEC_REQUESTS``
    requests, which the speculative serves are held to: (its tokens, its
    final KV lengths)."""
    import dataclasses

    rc_pt = dataclasses.replace(rc, quant_policy=ROBUST_POLICY)
    sched, done, _, _, prompts = serve(torch, cfg, rc_pt, params, "auto", requests=SPEC_REQUESTS)
    return check_served(cfg, sched, done, prompts, {8, 2}), sched.final_kv_lens


def serve_spec(torch, cfg, rc, params, want: dict, want_kv: dict, phase: str,
               draft_policy: str):
    """The first ``SPEC_REQUESTS`` of the serve phase's requests with
    speculative decoding (γ=4) under ``ROBUST_POLICY`` and ``draft_policy``:
    greedy tokens and final KV lengths equal to the plain ``ROBUST_POLICY``
    serve's of the same requests (``spec_reference``), no page left, only
    the fused GEMM, its stats assembly
    and attention launched on the cuda route. Prints drafted and accepted
    counts, the target's and the draft's ``cycles_by_bits``, tokens/s and
    launches a tick; under a self-draft below 0.99 acceptance, the first
    rejected (rid, position) and the target's top-2 logit margin there."""
    import dataclasses

    import repro_torch.serve.spec as spec_mod
    from repro_torch.kernels import ops

    rc_sp = dataclasses.replace(rc, quant_policy=ROBUST_POLICY, spec_gamma=SPEC_GAMMA,
                                draft_policy=draft_policy)
    first_reject = []
    accept = spec_mod.greedy_accept

    def watched(props, argmax_row):        # the first rejection's (rid, position)
        n, emitted = accept(props, argmax_row)
        if n < len(props) and not first_reject:
            sl = sys._getframe(1).f_locals["sl"]
            first_reject.append((sl.req.rid, sl.pos + n + 1))
        return n, emitted

    spec_mod.greedy_accept = watched
    try:
        sched, done, wall, counts, prompts = serve(torch, cfg, rc_sp, params, "auto",
                                                   requests=len(want))
    finally:
        spec_mod.greedy_accept = accept
    paths = ops.path_counts()
    got = {r.rid: list(r.out) for r in done}
    summ = sched.spec_summary()
    tgt, drf = _cycles_split(sched)
    rec = {**serve_record(phase, sched, done, wall, counts, prompts),
           "draft_policy": draft_policy, "spec_gamma": SPEC_GAMMA,
           "drafted_tokens": sched.drafted_tokens,
           "accepted_draft_tokens": sched.accepted_draft_tokens,
           "acceptance_rate": summ["acceptance_rate"],
           "target_cycles_by_bits": tgt, "draft_cycles_by_bits": drf,
           "energy_per_accepted_token_j": summ["energy_per_accepted_token_j"],
           "draft_energy_j": summ["draft_energy_j"], "target_energy_j": summ["target_energy_j"],
           "tokens_equal": sum(a == b for r in want for a, b in zip(want[r], got.get(r, []))),
           "tokens": sum(len(v) for v in want.values()),
           "final_kv_lens_equal": sched.final_kv_lens == want_kv}
    if draft_policy == ROBUST_POLICY and summ["acceptance_rate"] < 0.99 and first_reject:
        rid, at = first_reject[0]
        seq = list(prompts[rid]) + got[rid][: at - len(prompts[rid])]
        rec["first_rejection"] = {"rid": rid, "position": at,
                                  "target_top2_margin": _margin(torch, cfg, rc_sp, params, seq)}
    emit(rec)
    _pool_clean(phase, sched, done, len(prompts))
    if got != want or sched.final_kv_lens != want_kv:
        raise AssertionError(f"{phase}: speculative tokens or KV lengths differ from the plain "
                             f"serve's: {rec}")
    if sched.drafted_tokens <= 0 or (draft_policy != ROBUST_POLICY and set(drf) != {"2"}):
        raise AssertionError(f"{phase}: no int2 draft cycles: {rec}")
    _only_fused_on_cuda(phase, counts, paths)
    return sched, counts


def prefix_trace(cfg):
    """The shared-prompt trace: a warm request (a 96-token prefix, 6 full
    pages, + 8 tokens), then 8 requests of the same prefix + 8-40 unique
    tokens, then one whose prompt is exactly the 96 prefix tokens (numpy
    seed 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 96).tolist()
    warm = prefix + rng.integers(0, cfg.vocab_size, 8).tolist()
    burst = [prefix + rng.integers(0, cfg.vocab_size, int(rng.integers(8, 41))).tolist()
             for _ in range(8)]
    return [[warm], burst, [list(prefix)]]


def run_prefix_trace(torch, cfg, rc, params, **kw):
    """The trace's three waves, each run to the end before the next, on one
    scheduler (the serve's pool: capacity 256, 4 rows). Returns (scheduler,
    tokens by rid, wall s, kernel counts, paths), counts zeroed just before."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, Scheduler

    sched = Scheduler(cfg, rc, params, capacity=256, max_batch=4, track_energy=True,
                      device=DEVICE, **kw)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    rid = 0
    for wave in prefix_trace(cfg):
        for p in wave:
            if sched.submit(Request(rid=rid, prompt=p, max_new=PREFIX_NEW)) is not None:
                raise AssertionError(f"request {rid} refused at submit")
            rid += 1
        sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = {r.rid: list(r.out) for r in sched.finished}
    graphed_gate(sched)
    return sched, outs, wall, ops.kernel_counts(), ops.path_counts()


def serve_prefix(torch, cfg, rc, params):
    """The shared-prompt trace with ``prefix_cache`` off and then on, under
    ``ROBUST_POLICY``: the same greedy tokens, the warm request's
    ``cycles_by_bits`` identical, at least 8 admissions forking the prefix,
    fewer prefill tokens computed, invariants clean and no live page left;
    only the fused kernels launched. The last request's prompt is exactly
    the prefix: a fork stops one token short of a prompt's end, so it forks
    5 of the 6 pages and recomputes the sixth into a fresh page (the engine
    writes no shared page; ``cow_copy`` drives the copy-on-write drain).
    Prints live high-water marks, tokens/s and the ``cow_drain`` span's
    share of the tick (a tracer on the cached run). Returns the uncached
    run's tokens."""
    import dataclasses

    from repro_torch.obs import Tracer

    rc_pt = dataclasses.replace(rc, quant_policy=ROBUST_POLICY)
    off, out_off, wall_off, counts_off, paths_off = run_prefix_trace(torch, cfg, rc_pt, params)
    tr = Tracer()
    on, out_on, wall_on, counts_on, paths_on = run_prefix_trace(
        torch, cfg, dataclasses.replace(rc_pt, prefix_cache=True), params, tracer=tr)
    spans = {}
    for ev in tr.to_dict()["traceEvents"]:
        if ev.get("ph") == "X" and ev["name"] in ("tick", "cow_drain"):
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"]
    cyc = lambda s: {e["rid"]: e["cycles_by_bits"] for e in s.energy_summary()}
    gen = sum(len(v) for v in out_on.values())
    last = max(out_on)
    meters = {m.rid: m for m in on.finished_meters}
    rec = {"phase": "serve_prefix", "policy": ROBUST_POLICY, "requests": len(out_on),
           "new_tokens_each": PREFIX_NEW, "tokens": gen,
           "tokens_equal": sum(a == b for r in out_off for a, b in zip(out_off[r],
                                                                      out_on.get(r, []))),
           "prefix_hits": on.prefix_hits, "prefix_tokens_reused": on.prefix_tokens_reused,
           "prefill_tokens_computed": {"off": off.prefill_tokens_computed,
                                       "on": on.prefill_tokens_computed},
           "last_request_forked_tokens": meters[last].cached_prompt_tokens,
           "cow_events": on.mgr.cow_events,
           "live_high_water_pages": {"off": off.mgr.live_high_water,
                                     "on": on.mgr.live_high_water},
           "cached_pages_at_end": on.mgr.cached_pages,
           "wall_s": {"off": wall_off, "on_traced": wall_on},
           "tokens_per_s": {"off": gen / wall_off, "on_traced": gen / wall_on},
           "ticks": {"off": off.ticks, "on": on.ticks},
           "cow_drain_share_of_tick": spans.get("cow_drain", 0.0) / max(spans.get("tick", 1.0),
                                                                        1e-9),
           "warm_cycles_equal": cyc(on)[0] == cyc(off)[0],
           "health_prefix_cache": on.health()["prefix_cache"],
           "kernel_counts": counts_on, "paths": paths_on}
    emit(rec)
    for phase, sched in (("serve_prefix (off)", off), ("serve_prefix", on)):
        sched.mgr.check_invariants()
        if sched.mgr.live_pages or sched.engine_stalls or len(sched.finished) != 10:
            raise AssertionError(f"{phase}: a live page left, a stall or a request unfinished: "
                                 f"{sched.health()}")
        _only_fused_on_cuda(phase, counts_on if sched is on else counts_off,
                            paths_on if sched is on else paths_off)
    if out_on != out_off or not rec["warm_cycles_equal"]:
        raise AssertionError(f"serve_prefix: tokens or the warm request's cycles differ: {rec}")
    if on.prefix_hits < 8 or on.prefill_tokens_computed >= off.prefill_tokens_computed \
            or rec["last_request_forked_tokens"] != 80:
        raise AssertionError(f"serve_prefix: the prefix was not shared as planned: {rec}")
    return out_off


def cow_copy(torch, sched) -> dict:
    """The reference's COW device-copy test on the card, on a served
    prefix + spec scheduler's pools: the warm request's registered prefix
    forked onto two empty slots, slot 0 rolled back into the shared second
    page and extended (one copy-on-write queued); the source page of every
    leaf of both pools (int8 KV and f32 scales, target and draft) filled
    with seeded data; one drain, timed, and the same pair queued and drained
    again for a second time; every leaf's destination page must equal its
    source exactly. The slots are released after."""
    mgr, bs = sched.mgr, sched.rc.block_size
    warm = next(r for r in sched.finished if r.rid == 0)
    nodes, matched = mgr.lookup_prefix(list(warm.prompt) + list(warm.out), now=sched.clock + 1)
    if matched < 2 * bs:
        raise AssertionError(f"cow_copy: the warm request's prefix is not indexed ({matched})")
    for slot in (0, 1):
        mgr.fork_prefix(slot, nodes[:2], now=sched.clock + 1)
    mgr.truncate(0, 2 * bs - 1)
    before = mgr.cow_events
    if not mgr.extend(0, 2 * bs) or mgr.cow_events != before + 1:
        raise AssertionError("cow_copy: the write into the shared page queued no copy")
    src, dst = mgr.cow_copies[-1]
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    leaves = sched._pools()
    for leaf in leaves:
        leaf[:, src] = torch.randint(-120, 120, leaf[:, src].shape, generator=gen,
                                     device=leaf.device).to(leaf.dtype)
    want = [leaf[:, src].clone() for leaf in leaves]
    ms = []
    for _ in range(2):      # the first drain's time, then the same copy queued again
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched._drain_cow()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        mgr.cow_copies.append((src, dst))
    mgr.drain_cow_copies()
    exact = sum(bool(torch.equal(leaf[:, dst], w)) for leaf, w in zip(leaves, want))
    for slot in (0, 1):
        mgr.release(slot)
    mgr.check_invariants()
    rec = {"phase": "cow_copy", "leaves": len(leaves), "leaves_exact": exact,
           "draft_leaves": len(leaves) // 2, "src": src, "dst": dst,
           "bytes_copied": sum(w.numel() * w.element_size() for w in want),
           "ms_first": ms[0], "ms_again": ms[1],
           "live_pages_after": mgr.live_pages}
    emit(rec)
    if sched.spec is None or exact != len(leaves) or mgr.live_pages:
        raise AssertionError(f"cow_copy: a destination page differs from its source: {rec}")
    return rec


def serve_prefix_spec(torch, cfg, rc, params, want: dict):
    """Prefix caching and speculative decoding (γ=4, ``*=int2`` draft)
    together on the shared-prompt trace: tokens equal to the plain uncached
    run's; then ``cow_copy`` on its pools."""
    import dataclasses

    rc_ps = dataclasses.replace(rc, quant_policy=ROBUST_POLICY, prefix_cache=True,
                                spec_gamma=SPEC_GAMMA, draft_policy="*=int2")
    sched, outs, wall, counts, paths = run_prefix_trace(torch, cfg, rc_ps, params)
    summ = sched.spec_summary()
    rec = {"phase": "serve_prefix_spec", "policy": ROBUST_POLICY, "draft_policy": "*=int2",
           "spec_gamma": SPEC_GAMMA, "tokens": sum(len(v) for v in outs.values()),
           "tokens_equal": sum(a == b for r in want for a, b in zip(want[r], outs.get(r, []))),
           "prefix_hits": sched.prefix_hits, "drafted_tokens": sched.drafted_tokens,
           "accepted_draft_tokens": sched.accepted_draft_tokens,
           "acceptance_rate": summ["acceptance_rate"], "ticks": sched.ticks, "wall_s": wall,
           "tokens_per_s": sum(len(v) for v in outs.values()) / wall,
           "kernel_launches_per_tick": sum(c["launches"] for c in counts.values()) / sched.ticks,
           "kernel_counts": counts, "paths": paths}
    emit(rec)
    sched.mgr.check_invariants()
    if outs != want or sched.mgr.live_pages or sched.prefix_hits < 8 or not sched.drafted_tokens:
        raise AssertionError(f"serve_prefix_spec: tokens differ from the plain uncached run's, "
                             f"a live page is left or nothing was shared or drafted: {rec}")
    _only_fused_on_cuda("serve_prefix_spec", counts, paths)
    return sched, counts, cow_copy(torch, sched)


# serve_traced's serves: the first 4 of the serve phase's 8 requests (for the
# script's time limit)
TRACED_REQUESTS = 4
# the device kernel (a substring of its name in the profiler's events) that
# each wrapper of the fused serve launches once a call; no other wrapper
# of that serve launches (the int8 and packed GEMMs share gemm_kernel)
SERVE_DEVICE_KERNELS = {"tugemm_fused": "tugemm::gemm_kernel<",
                        "flash_paged_decode": "flash_split_kernel<",
                        "tugemm_stats": "finish_kernel<"}


def serve_traced(torch, cfg, rc, params, smi: str):
    """The first ``TRACED_REQUESTS`` of the serve phase's requests with a
    ``Tracer`` and a ``MetricsRegistry``, without and with
    ``obs.device_trace``. First two serves (untraced, traced) for tick ms
    with tracing on and off in this call; then one traced serve inside
    ``device_trace``, last, since a profiler session over a whole serve
    slows the rest of the process. Every traced serve gives the untraced
    serve's tokens and ``cycles_by_bits``; the host trace passes
    ``validate_chrome_trace``; the
    ``torch.profiler`` trace (build/serve_traced/) holds the ``serve/step``
    and ``serve/logits`` ranges and the kernels. The profiler must start:
    this phase fails where ``device_trace`` would only warn. The profiled
    serve replays graphs: the trace's kernel events by name must equal the
    launches the graphs credited each kernel of the serve. Returns
    {kernel: {"credited": n, "profiled": events}}."""
    from repro_torch.obs import (MetricsRegistry, Tracer, device_trace, trace_summary,
                                 validate_chrome_trace)

    runs = {"off": [], "on": []}
    for mode in ("off", "on"):
        kw = dict(tracer=Tracer(), metrics=MetricsRegistry()) if mode == "on" else {}
        sched, done, wall, _, _ = serve(torch, cfg, rc, params, "auto",
                                        requests=TRACED_REQUESTS, **kw)
        runs[mode].append((sched, done, wall))
    tracer = Tracer()
    t0 = time.perf_counter()
    with device_trace(os.path.join(HERE, "build", "serve_traced")) as path:
        if path is None:
            raise AssertionError("serve_traced: torch.profiler did not start")
        sched, done, wall_prof, counts, _ = serve(torch, cfg, rc, params, "auto",
                                                  tracer=tracer, metrics=MetricsRegistry(),
                                                  requests=TRACED_REQUESTS)
    export_s = time.perf_counter() - t0 - wall_prof
    runs["profiled"] = [(sched, done, wall_prof)]
    host = tracer.to_dict()
    validate_chrome_trace(host)
    if not os.path.exists(path):
        raise AssertionError("serve_traced: the profiler wrote no trace")
    with open(path) as f:
        text = f.read()
    found = {n: text.count(f'"{n}"') for n in ("serve/step", "serve/logits")}
    found.update({n: text.count(n) for n in ("gemm_kernel", "flash_split_kernel",
                                             "finish_kernel")})
    trace_bytes = len(text)
    events = [e for e in json.loads(text, strict=False)["traceEvents"] if e.get("ph") == "X"]
    del text
    launches = {name: {"credited": counts[name]["launches"],
                       "profiled": sum(sub in e.get("name", "") for e in events)}
                for name, sub in SERVE_DEVICE_KERNELS.items()}
    others = {k: c["launches"] for k, c in counts.items()
              if k not in SERVE_DEVICE_KERNELS and c["launches"]}
    del events

    def lat(mode, key, p):
        return [r[0].health()["latency"][key][p] * 1e3 for r in runs[mode]]

    rec = {"phase": "serve_traced", "card": smi, "policy": rc.quant_policy,
           "order": "off, on, then on with the profiler", "requests": TRACED_REQUESTS,
           "tick_ms_p50": {m: lat(m, "tick_s", "p50") for m in runs},
           "tick_ms_p99": {m: lat(m, "tick_s", "p99") for m in runs},
           "ttft_ms_p50": {m: lat(m, "ttft_s", "p50") for m in runs},
           "ttft_ms_p99": {m: lat(m, "ttft_s", "p99") for m in runs},
           "itl_ms_p50": {m: lat(m, "itl_s", "p50") for m in runs},
           "itl_ms_p99": {m: lat(m, "itl_s", "p99") for m in runs},
           "median_step_ms": {m: [statistics.median(r[0].tick_seconds) * 1e3 for r in runs[m]]
                              for m in runs},
           "wall_s": {m: [r[2] for r in runs[m]] for m in runs},
           "profiler_export_s": export_s, "trace_bytes": trace_bytes,
           "profiler_ranges": found, "host_trace": trace_summary(host)["spans"],
           "graph_replays": step_record(sched)["graph_replays"], "launches": launches}
    emit(rec)
    sched_off, done_off, _ = runs["off"][0]
    outs = {r.rid: list(r.out) for r in done_off}
    for s, d, _ in runs["on"] + runs["profiled"]:
        if {r.rid: list(r.out) for r in d} != outs or s.cycles_by_bits != sched_off.cycles_by_bits:
            raise AssertionError("serve_traced: tracing changed tokens or cycle counts")
    if not all(found.values()):
        raise AssertionError(f"serve_traced: the profiler trace lacks a range or kernel: {found}")
    if (not rec["graph_replays"] or others
            or any(v["profiled"] != v["credited"] or not v["credited"]
                   for v in launches.values())):
        raise AssertionError(f"serve_traced: the kernels the graphed serve ran (trace) differ "
                             f"from the launches it counted: {launches}, others {others}")
    return launches


def serve_moe_phases(torch) -> dict:
    """The MLA + MoE slice on deepseek-v2-lite at full width: step parity
    (kernels against plain versions, and the router's choices on both
    paths), then the serve under the fused dynamic policy and, after
    ``apply_surgery``, under the prequant one (``_serve_gated``), then the
    unfused expert route on the same weights (``serve_moe_unfused``). Each
    serve's kernel counts are zeroed just before it and read just after.
    Returns {phase: (ticks, counts)}."""
    cfg, rc, params, init_s = model_setup_moe(torch)
    emit({"phase": "init_moe", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "experts": cfg.num_experts, "seconds": init_s,
          "params": sum(t.numel() for t in _leaves(params)),
          "device_bytes": torch.cuda.memory_allocated()})
    step_parity_moe(torch, cfg, rc, params)
    out = {}
    for phase, policy in (("serve_moe", MOE_POLICY), ("serve_moe_prequant", MOE_PREQUANT_POLICY)):
        rc_p, params_p = surgered(cfg, rc, params, policy)
        out[phase], _ = _serve_gated(torch, phase, cfg, rc_p, params_p, {8, 2},
                                     time.perf_counter())
        del params_p
    out.update(serve_moe_unfused(torch, cfg, rc, params))
    del params
    free_device_memory(torch)
    return out


def _checked_expert_gemms(torch, ops, log: dict):
    """Wrap ``ops.matmul_int8`` / ``ops.matmul_packed`` so that every call
    on an expert stack (3-D operands) is held bit for bit against its plain
    arithmetic (``kernels/ref.py``: the product, and with stats their
    assembly from both operands' maxima), which no counter sees; ``log``
    counts the checked calls under the kernel's name and the 2-D calls (the
    shared experts, which the ``moe.*`` rule also takes) under
    ``<name>_2d``. Returns the two originals, for the caller to put back."""
    from repro_torch.kernels.ref import (colabsmax_ref, finish_stats_ref, matmul_int_ref,
                                         packed_matmul_ref, rowabsmax_ref)

    int8, packed = ops.matmul_int8, ops.matmul_packed

    def note(name, ok):
        log[name] = log.get(name, 0) + 1
        if not ok:
            log.setdefault("mismatches", []).append(name)

    def int8_checked(a, b, c=None, *, collect_stats=False, impl="auto"):
        out = int8(a, b, c, collect_stats=collect_stats, impl=impl)
        if a.ndim == 3:
            y, st = out if collect_stats else (out, None)
            ok = torch.equal(y, matmul_int_ref(a, b, c))
            if collect_stats:
                want = finish_stats_ref(colabsmax_ref(a).unsqueeze(-2),
                                        rowabsmax_ref(b).unsqueeze(-1), a.shape[-1])
                ok = ok and all(f.dtype == g.dtype and torch.equal(f, g)
                                for f, g in zip(st, want))
            note("tugemm_int8", ok)
        else:
            log["tugemm_int8_2d"] = log.get("tugemm_int8_2d", 0) + 1
        return out

    def packed_checked(a, packed_b, *, bits, impl="auto"):
        out = packed(a, packed_b, bits=bits, impl=impl)
        if a.ndim == 3:
            pad = packed_b.shape[-2] * (8 // bits) - a.shape[-1]
            want = packed_matmul_ref(torch.nn.functional.pad(a, (0, pad)), packed_b, bits)
            note("tugemm_packed", torch.equal(out, want))
        else:
            log["tugemm_packed_2d"] = log.get("tugemm_packed_2d", 0) + 1
        return out

    ops.matmul_int8, ops.matmul_packed = int8_checked, packed_checked
    return int8, packed


def serve_moe_unfused(torch, cfg, rc, params) -> dict:
    """The unfused expert route on deepseek-v2-lite at full width: the serve
    phase's requests under ``MOE_UNFUSED_POLICY`` (each MoE layer's 3 expert
    GEMMs quantized per expert, then one ``tugemm_int8`` launch with stats
    over all 64 experts) and, after ``apply_surgery``, under
    ``MOE_UNFUSED_PREQUANT_POLICY`` (one ``tugemm_packed`` launch over the
    experts' int2 planes). Every expert GEMM call of both serves is held bit
    for bit against its plain arithmetic (``_checked_expert_gemms``: the
    serves' wall time includes those checks). Only the fused GEMM (MLA),
    attention, ``tugemm_stats`` and the route's kernel launch, no plain
    call; every request finishes with in-vocabulary tokens and cycles at the
    route's bits ({8, 2}; the prequant route records no expert cycles, as
    the reference's does, {8}); the two serves' expert GEMMs compute the
    same integers, so their tokens and int8 cycles are equal. The checked
    serves step eagerly (a check reads each call's result on the host,
    which a graph capture cannot); the same requests then replay as CUDA
    graphs, with tokens, ``cycles_by_bits`` and kernel counts equal to the
    checked serve's. Returns {phase: (ticks, counts)}."""
    from repro_torch.kernels import ops

    out, outs, cyc8 = {}, {}, {}
    for phase, policy, gemm, bits in (
            ("serve_moe_unfused", MOE_UNFUSED_POLICY, "tugemm_int8", {8, 2}),
            ("serve_moe_unfused_prequant", MOE_UNFUSED_PREQUANT_POLICY, "tugemm_packed", {8})):
        rc_p, params_p = surgered(cfg, rc, params, policy)
        log: dict = {}
        orig = _checked_expert_gemms(torch, ops, log)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            sched, done, wall, counts, prompts = serve(torch, cfg, rc_p, params_p, "auto",
                                                       requests=MOE_UNFUSED_REQUESTS,
                                                       graphs=False)
        finally:
            ops.matmul_int8, ops.matmul_packed = orig
        outs[phase] = check_served(cfg, sched, done, prompts, bits)
        cyc8[phase] = sched.cycles_by_bits[8]
        rec = serve_record(phase, sched, done, wall, counts, prompts)
        g_sched, g_done, g_wall, g_counts, _ = serve(torch, cfg, rc_p, params_p, "auto",
                                                     requests=MOE_UNFUSED_REQUESTS)
        graphed = serve_record(phase + " graphed", g_sched, g_done, g_wall, g_counts, prompts)
        rec.update(expert_calls_checked=log.get(gemm, 0),
                   shared_expert_calls=log.get(gemm + "_2d", 0),
                   expert_mismatches=log.get("mismatches", []),
                   wall_includes_checks=True, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   graphed={k: graphed[k] for k in ("wall_s", "tokens_per_s", "median_tick_ms",
                                                    "graph_replays", "eager_step_calls",
                                                    "graph_pool_bytes", "capture_ms")},
                   seconds=time.perf_counter() - t0)
        emit(rec)
        if ({r.rid: list(r.out) for r in g_done} != outs[phase] or g_counts != counts
                or g_sched.cycles_by_bits != sched.cycles_by_bits):
            raise AssertionError(f"{phase}: the graphed serve's tokens, cycles or kernel counts "
                                 f"differ from the checked eager serve's: {graphed}")
        want = {"tugemm_fused", "flash_paged_decode", "tugemm_stats", gemm}
        ran = {k for k, c in counts.items() if c["launches"] > 0}
        routes = {path for p in rec["paths"].values() for path in p}
        if ran != want or any(c["plain_calls"] for c in counts.values()) or routes != {"cuda"}:
            raise AssertionError(f"{phase} did not run only {sorted(want)} on the cuda route: "
                                 f"{counts} {rec['paths']}")
        if log.get("mismatches") or not log.get(gemm) \
                or log[gemm] + log.get(gemm + "_2d", 0) != counts[gemm]["launches"]:
            raise AssertionError(f"{phase}: an expert GEMM call disagrees with its plain version "
                                 f"or went unchecked: {log} {counts[gemm]}")
        out[phase] = (types.SimpleNamespace(ticks=sched.ticks), counts)
        del params_p, sched, g_sched
    (a, b), (ca, cb) = outs.values(), cyc8.values()
    same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    emit({"phase": "moe_unfused_vs_prequant", "tokens_equal": same,
          "tokens": sum(len(o) for o in a.values()), "int8_cycles_equal": ca == cb})
    if a != b or ca != cb:
        raise AssertionError("the unfused expert serves' tokens or int8 cycles differ")
    return out


# ------------------------------- the last archs: hubert, qwen2-vl, llama4
def _init_on_card(torch, cfg, rc, phase: str, **extra):
    """``cfg``'s bf16 weights drawn on the card by a CUDA generator seeded 0;
    emits ``phase``'s init line (seconds, parameters, weight GB)."""
    from repro_torch.models import init

    t0 = time.perf_counter()
    params = init(cfg, rc, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    torch.cuda.synchronize()
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "seconds": time.perf_counter() - t0, "params": sum(t.numel() for t in _leaves(params)),
          "weight_gb": sum(nbytes(t) for t in _leaves(params)) / 1e9,
          "device_bytes": torch.cuda.memory_allocated(), **extra})
    return params


def encode_audio(torch) -> dict:
    """hubert-xlarge at full width (48 layers, d_model 1280, 16 heads, d_ff
    5120, vocab 504) encodes ``AUDIO_CLIPS`` clips of ``AUDIO_FRAMES`` stub
    frames (512-d, the reference's stand-in for the conv frontend) under
    ``AUDIO_POLICY``: one no-cache, non-causal forward and the head, through
    the kernels (only ``tugemm_fused`` and ``tugemm_stats`` launch; no
    paged attention) and through the plain versions on the card. Per-frame
    argmax and ``cycles_by_bits`` identical, hidden states within
    ``AUDIO_REL_TOL`` relative L2. Frames/s from the host clock, event ms
    (the CUDA-event span of the kernel forward). Returns (record, counts)."""
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm_logits
    from repro_torch.quant.capture import tree_totals_by_bits
    from repro_torch.quant.surgery import forward_with_stats

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(AUDIO_ARCH)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", quant_policy=AUDIO_POLICY)
    params = _init_on_card(torch, cfg, rc, "init_audio")
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    batch = {"embeds": torch.randn(AUDIO_CLIPS, AUDIO_FRAMES, 512, device=DEVICE, generator=gen)}

    @torch.no_grad()
    def run(impl):
        h, _, _, cap = forward_with_stats(cfg, rc, params, batch, caches=None, cache_pos=None,
                                          kv_view=None, impl=impl)
        return h, lm_logits(cfg, rc, params, h, impl=impl), cap

    run("auto")
    torch.cuda.synchronize()
    ops.reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    h, logits, cap = run("auto")
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.kernel_counts()
    cyc = tree_totals_by_bits(cap)
    ph, plogits, pcap = run("torch")
    pcyc = tree_totals_by_bits(pcap)
    frames = AUDIO_CLIPS * AUDIO_FRAMES
    shape_ok = (tuple(h.shape) == (AUDIO_CLIPS, AUDIO_FRAMES, cfg.d_model)
                and tuple(logits.shape) == (AUDIO_CLIPS, AUDIO_FRAMES, cfg.vocab_size)
                and bool(h.isfinite().all()) and bool(logits.isfinite().all()))
    hf, pf = h.float(), ph.float()
    rec = {"phase": "encode_audio", "arch": cfg.name, "layers": cfg.num_layers,
           "policy": AUDIO_POLICY, "clips": AUDIO_CLIPS, "frames_per_clip": AUDIO_FRAMES,
           "wall_s": wall, "frames_per_s": frames / wall, "event_ms": start.elapsed_time(end),
           "argmax_equal_frames": int((logits.argmax(-1) == plogits.argmax(-1)).sum()),
           "frames": frames, "hidden_rel_l2": ((hf - pf).norm() / pf.norm()).item(),
           "hidden_max_abs": (hf - pf).abs().max().item(), "tol_rel_l2": AUDIO_REL_TOL,
           "cycles_by_bits": {str(b): v for b, v in sorted(cyc.items())},
           "cycles_equal_plain": cyc == pcyc, "kernel_counts": counts,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    ran = {k for k, c in counts.items() if c["launches"] > 0}
    if not shape_ok or set(cyc) != {8, 2} or cyc != pcyc \
            or rec["argmax_equal_frames"] != frames or rec["hidden_rel_l2"] > AUDIO_REL_TOL:
        raise AssertionError(f"encode_audio: the kernel forward is not the plain one's: {rec}")
    if ran != ENGINE_KERNELS or any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"encode_audio did not run only the fused GEMM and its stats: "
                             f"{counts}")
    del params, h, ph, logits, plogits, cap, pcap
    free_device_memory(torch)
    return rec, counts


def _serve_gated(torch, phase, cfg, rc, params, bits: set, t_phase: float):
    """One serve of the serve phase's requests through the kernels, gated as
    the qwen3-0.6b serve is: every request done with 16 in-vocabulary
    tokens and cycles at ``bits``, only the fused GEMM, attention and the
    stats assembly launching, no plain call, every call site on the cuda
    route. Its line adds the peak memory since the last reset and the
    seconds since ``t_phase``. Returns ((ticks, counts), {rid: tokens}): the
    tick count, not the scheduler, which holds the weights the next phases
    need the room of."""
    sched, done, wall, counts, prompts = serve(torch, cfg, rc, params, "auto")
    outs = check_served(cfg, sched, done, prompts, bits)
    rec = serve_record(phase, sched, done, wall, counts, prompts)
    rec.update(peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               seconds=time.perf_counter() - t_phase)
    if sched.tick_dropped_tokens:
        w_bytes = expert_w_bytes(params)
        rec.update(expert_w_bytes_per_tick=w_bytes,
                   expert_w_bound_ms_per_tick=w_bytes / HBM_BYTES_PER_S * 1e3)
    emit(rec)
    ran = {k for k, c in counts.items() if c["launches"] > 0}
    routes = {path for p in rec["paths"].values() for path in p}
    if ran != set(FUSED_KERNELS) or any(c["plain_calls"] for c in counts.values()) \
            or routes != {"cuda"}:
        raise AssertionError(f"{phase} did not run only the fused kernels on the cuda route: "
                             f"{counts} {rec['paths']}")
    return (types.SimpleNamespace(ticks=sched.ticks), counts), outs


def serve_vl(torch) -> dict:
    """qwen2-vl-7b at full width (28 layers, d_model 3584, 28 / 4 heads of
    128, d_ff 18944, vocab 152064; ~7.6 B bf16 parameters drawn on the card)
    under the fused dynamic ``POLICY`` with int8 paged KV: one prefill and
    one decode tick of the mixed step with ``mrope_sections`` set (positions
    (3, B, W), t = h = w) against the same ticks with it cleared (RoPE):
    logits bit for bit, since every M-RoPE angle is then the product RoPE
    takes; ``step_parity_moe``'s gated parts (the GEMMs' plain versions
    with attention on its kernel exact; attention's kernel against its
    plain version under ``*=bf16``); then the serve phase's 8
    requests through ``Scheduler.run``, gated as the qwen3-0.6b serve.
    Returns {phase: (ticks, counts)}."""
    from repro_torch.configs.base import RunConfig, get_config

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(VL_ARCH)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", quant_policy=POLICY,
                   kv_cache_dtype="int8", kv_layout="paged", block_size=16, prefill_chunk=16)
    params = _init_on_card(torch, cfg, rc, "init_vl", mrope_sections=list(cfg.mrope_sections))
    mrope = _mixed_ticks(torch, cfg, rc, params, "cuda")
    rope = _mixed_ticks(torch, cfg.replace(mrope_sections=None), rc, params, "cuda")
    equal = [bool(torch.equal(a, b)) for a, b in zip(mrope[:2], rope[:2])]
    emit({"phase": "mrope_vs_rope", "arch": cfg.name, "prefill_equal": equal[0],
          "decode_equal": equal[1], "rows": len(mrope[2]),
          "max_abs": max((a - b).abs().max().item() for a, b in zip(mrope[:2], rope[:2]))})
    if not all(equal):
        raise AssertionError("qwen2-vl's M-RoPE step with t = h = w is not the RoPE step")
    # gated as the MoE step is: through 28 layers of int2 MLPs 18944 wide,
    # the all-plain step's one-ulp attention differences moved the decode
    # logits by 0.35 relative L2 on an H100, as deepseek-v2-lite's move
    # theirs; that comparison is printed only
    step_parity_moe(torch, cfg, rc, params, "step_parity_vl")
    out = {}
    out["serve_vl"], _ = _serve_gated(torch, "serve_vl", cfg, rc, params, {8, 2}, t_phase)
    del params
    free_device_memory(torch)
    return out


def serve_llama4(torch) -> dict:
    """llama4-maverick-400b-a17b at full width with its depth cut 48 -> 2
    (``LLAMA4_LAYERS``): layer 0 dense, layer 1 MoE over 128 experts, top-1,
    with the shared expert (~37 GB of bf16 weights drawn on the card):
    ``step_parity_moe`` (the routing hook's teacher-forced parity), then the
    serve phase's requests under ``LLAMA4_POLICY`` (the expert GEMMs quantized
    on load, int2) and, after ``apply_surgery``, ``LLAMA4_PREQUANT_POLICY``
    (packed int2 experts), each gated as ``serve_moe``.
    Returns {phase: (ticks, counts)}."""
    from repro_torch.configs.base import RunConfig, get_config

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(LLAMA4_ARCH)
    cfg = full.replace(num_layers=LLAMA4_LAYERS)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", quant_policy=LLAMA4_POLICY,
                   kv_cache_dtype="int8", kv_layout="paged", block_size=16, prefill_chunk=16)
    params = _init_on_card(
        torch, cfg, rc, "init_llama4", experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
        reduced=f"depth {full.num_layers} -> {cfg.num_layers} layers: layer 0 dense, layer 1 "
                f"MoE ({cfg.num_experts} experts top-{cfg.num_experts_per_tok} + "
                f"{cfg.num_shared_experts} shared); widths as published")
    step_parity_moe(torch, cfg, rc, params, "step_parity_llama4")
    out = {}
    for phase, policy in (("serve_llama4", LLAMA4_POLICY),
                          ("serve_llama4_prequant", LLAMA4_PREQUANT_POLICY)):
        rc_p, params_p = surgered(cfg, rc, params, policy)
        out[phase], _ = _serve_gated(torch, phase, cfg, rc_p, params_p, {8, 2}, t_phase)
        del params_p
        free_device_memory(torch)
    del params
    free_device_memory(torch)
    return out


# ------------------------- the serving CLI, the last dense archs, static scales
DENSE_ARCHS = ("qwen3-8b", "qwen3-14b", "smollm-360m")
# the CLI phases: launch.serve.main in-process at full width, paged int8 KV
# under POLICY with prefix caching and per-request energy, 8 requests of 64
# prompt tokens and 16 new tokens
CLI_PHASES = (("serve_cli_qwen3_8b", "qwen3-8b"), ("serve_cli_smollm", "smollm-360m"))
CLI_ARGS = ["--kv-layout", "paged", "--kv-dtype", "int8", "--policy", POLICY,
            "--prefix-cache", "--energy", "--requests", "8", "--prompt-len", "64",
            "--max-new", "16"]
QWEN14_ARCH = "qwen3-14b"
CALIB_ARCH, CALIB_POLICY = "smollm-360m", "*=int8"
# the static-scale profile's expected max |q| (on the 0..127 code scale),
# kernels against plain versions: both run the same registry, the fused GEMM
# holds its plain version bit for bit and the no-cache attention is plain on
# both sides, so every record and the expected max agree exactly
CALIB_EMAX_TOL = 0.0


def dense_widths(cfg) -> list:
    """(name, K, N, bits) of one layer's distinct GEMM widths under POLICY
    (q and o share a shape where heads · head_dim = d_model)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    seen, out = set(), []
    for g in (("attn.q", d, q, 8), ("attn.k/v", d, kv, 8), ("attn.o", q, d, 8),
              ("mlp.gate/up", d, cfg.d_ff, 2), ("mlp.down", cfg.d_ff, d, 2)):
        if g[1:] not in seen:
            seen.add(g[1:])
            out.append(g)
    return out


def check_dense_widths(torch, flush):
    """``tugemm_fused`` and ``flash_paged_decode`` at the three dense archs'
    shapes. The GEMM: every distinct width of one layer of each arch at
    M = 64 and 4, at the bits POLICY gives it, quantized on load (int8 and
    int2) and from packed int2 planes, plus static scales set to half the
    operand's absmax (``reg / hi`` as the static branch takes it, so codes
    past half the range clip): int8 on the q width at M = 64, packed int2
    on the gate/up width at M = 4. Each bit for bit against its plain
    version, outputs and stats; ``torch._int_mm`` on the int8 operands as the
    library where cuBLASLt takes the shape. Attention: smollm-360m's 15 q
    heads over 5 kv heads (group 3, head_dim 64), qwen3-14b's group 5 and
    qwen3-8b's group 4 at head_dim 128, on int8 pools, against the plain
    version within ``ATTN_TOL``, SDPA as the library. Returns (GEMM records,
    attention records)."""
    from repro_torch.configs.base import get_config
    from repro_torch.quant.quantize import act_scale, fused_scales, weight_scale
    from repro_torch.quant.surgery import _prequant_leaf

    dev = torch.device(DEVICE)
    bf16, i8 = torch.bfloat16, torch.int8
    gemms = []
    for i, arch in enumerate(DENSE_ARCHS):
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(20 + i)

        def run(case, *args, **extra):
            gemms.append(fused_case(torch, "check_dense_widths", f"{arch} {case}", *args,
                                    flush, model=arch, **extra))

        widths = dense_widths(cfg)
        for M in (64, 4):
            for name, K, N, bits in widths:
                x = torch.randn(M, K, device=dev, generator=gen).to(bf16)
                wf = (torch.randn(K, N, device=dev, generator=gen) * 0.02).to(bf16)
                sx, sw = fused_scales(x, wf, bits)
                lib = lib_int_mm(torch, *int8_operands(torch, x, wf, sx, sw, bits))
                run(f"{name} dynamic", x, wf, sx, sw, bits, False, lib)
                if bits < 8:
                    leaf = _prequant_leaf(wf, bits)
                    run(f"{name} packed", x, leaf["qkernel"], act_scale(x, bits),
                        leaf["qscale"], bits, True, lib)
        for (name, K, N, bits), M, packed in ((widths[0], 64, False), (widths[-2], 4, True)):
            x = torch.randn(M, K, device=dev, generator=gen).to(bf16)
            wf = (torch.randn(K, N, device=dev, generator=gen) * 0.02).to(bf16)
            hi = 2 ** (bits - 1) - 1
            reg = float(x.abs().amax()) / 2
            sx = torch.tensor(reg / hi, dtype=torch.float32, device=dev)
            clipped = float(((x.float() / sx).round().abs() > hi).float().mean())
            sw = weight_scale(wf, bits)
            lib = lib_int_mm(torch, *int8_operands(torch, x, wf, sx, sw, bits))
            w = wf
            if packed:
                leaf = _prequant_leaf(wf, bits)
                w, sw = leaf["qkernel"], leaf["qscale"]
            run(f"{name} static {'packed' if packed else 'quant'}", x, w, sx, sw, bits, packed,
                lib, static=True, clipped_share=clipped)
            if clipped <= 0:
                raise AssertionError(f"the static scale clipped no code: {gemms[-1]}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(23)
    smol = dict(kv=5, group=3, part_dims=(64,), hdv=64, bs=16, MB=128)
    q14 = dict(kv=8, group=5, part_dims=(128,), hdv=128, bs=16, MB=128)
    q8 = dict(q14, group=4)
    dec = [(2047, 1), (1000, 1), (0, 0), (16, 1)]
    pre = [(2032, 16), (500, 16), (0, 0), (0, 16)]
    # the CLI serve's own pool: capacity 128 in pages of 16, 64-token prompts
    cli = [(48, 16), (79, 1), (0, 0), (64, 1)]
    cases = [("smollm_decode_int8", smol, dec, 1), ("smollm_step16_int8", smol, pre, 16),
             ("smollm_cli_step16_int8", dict(smol, MB=8), cli, 16),
             ("qwen3_14b_decode_int8", q14, dec, 1), ("qwen3_14b_step16_int8", q14, pre, 16),
             ("qwen3_8b_decode_int8", q8, dec, 1)]
    attn = [attn_check(torch, gen, sms, flush, name, shape, rows, sq, i8, bf16, None,
                       phase="check_dense_widths") for name, shape, rows, sq in cases]
    return gemms, attn


def serve_cli(torch, phase: str, arch: str):
    """``repro_torch.launch.serve.main`` in-process with ``CLI_ARGS`` on
    ``arch`` at full width (bf16 weights drawn on the card by the CLI): the
    counts zeroed just before ``main`` and read just after; every request
    done with 16 in-vocabulary tokens and nonzero ``cycles_by_bits`` at 8
    and 2 bits, only the fused GEMM, its stats assembly and attention
    launching, every call site on the cuda route. The CLI prints its own
    tokens/s and health lines. Returns ((ticks, counts), record)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as cli

    t_phase = _phase_start(torch, phase)["t0"]
    made = []
    base = cli.Scheduler

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    cli.Scheduler = Recorded
    try:
        ops.reset_counts()
        t0 = time.perf_counter()
        done = cli.main(["--arch", arch, *CLI_ARGS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, paths = ops.kernel_counts(), ops.path_counts()
    finally:
        cli.Scheduler = base
    sched = made[0]
    gen = sum(len(r.out) for r in done)
    energy = sched.energy_summary()
    h = sched.health()
    rec = {"phase": phase, "arch": arch, "argv": CLI_ARGS, "layers": sched.cfg.num_layers,
           "requests": len(done), "generated_tokens": gen, "wall_s_with_init": wall,
           "serve_s": sum(sched.tick_seconds), "tokens_per_s": gen / sum(sched.tick_seconds),
           "ticks": sched.ticks, "median_tick_ms": statistics.median(sched.tick_seconds) * 1e3,
           "cycles_by_bits": {str(b): v for b, v in sorted(sched.cycles_by_bits.items())},
           "request_cycles_by_bits": [{str(b): v for b, v in sorted(e["cycles_by_bits"].items())}
                                      for e in energy],
           "health": {k: h[k] for k in ("completed", "rejections", "preemptions",
                                        "deadline_misses", "stall_episodes", "engine_stalls")},
           "ladder": h["ladder"]["name"], "prefix_cache": h["prefix_cache"],
           "kernel_counts": counts, "paths": paths, **step_record(sched),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    graphed_gate(sched)
    if len(done) != 8 or any(len(r.out) != 16 or not all(0 <= t < sched.cfg.vocab_size
                                                          for t in r.out) for r in done):
        raise AssertionError(f"{phase}: not every request finished with 16 tokens")
    if len(energy) != 8 or any(set(e["cycles_by_bits"]) != {8, 2}
                               or min(e["cycles_by_bits"].values()) <= 0 for e in energy):
        raise AssertionError(f"{phase}: a request without cycles at 8 and 2 bits: {energy}")
    _only_fused_on_cuda(phase, counts, paths)
    out = (types.SimpleNamespace(ticks=sched.ticks), counts)
    del made, sched, done
    free_device_memory(torch)
    return out, rec


def serve_qwen3_14b(torch) -> dict:
    """qwen3-14b at full width (40 layers, d_model 5120, 40 / 8 heads of 128,
    d_ff 17408; ~14.8 B bf16 parameters drawn on the card): the mixed step
    under PREQUANT_POLICY on the float weights (a prequant rule on a float
    leaf quantizes on load, bit-exact with the packed leaf) through
    ``step_parity_moe``'s gated parts, then ``apply_surgery`` (the float MLP
    weights are dropped for their int2 planes) and the serve phase's 8
    requests, gated as the qwen3-0.6b serve. Returns {phase: (ticks, counts)}."""
    from repro_torch.configs.base import RunConfig, get_config

    t_phase = _phase_start(torch, "serve_qwen3_14b")["t0"]
    cfg = get_config(QWEN14_ARCH)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", quant_policy=PREQUANT_POLICY,
                   kv_cache_dtype="int8", kv_layout="paged", block_size=16, prefill_chunk=16)
    params = _init_on_card(torch, cfg, rc, "init_qwen3_14b")
    step_parity_moe(torch, cfg, rc, params, "step_parity_qwen3_14b")
    rc_pq, params_pq = surgered(cfg, rc, params, PREQUANT_POLICY)
    del params
    free_device_memory(torch)
    out = {}
    out["serve_qwen3_14b"], _ = _serve_gated(torch, "serve_qwen3_14b", cfg, rc_pq, params_pq,
                                             {8, 2}, t_phase)
    del params_pq
    free_device_memory(torch)
    return out


def _first_records(col, names) -> dict:
    """{name: the collector's first record of that GEMM name} (layer 0's)."""
    return {n: next(r for r in col.records if r.name == n) for n in names}


def calibrate_static(torch) -> dict:
    """Static-scale calibration on smollm-360m at full width under
    ``CALIB_POLICY``: one calibration forward (4 x 64 tokens) through the
    kernels builds the registry; then ``static_scales`` with ``collecting()``
    on a second batch through the kernels and through the plain versions,
    the same registry: every record identical (layer 0's q/k/v and the
    first differing record named on failure), the profile's expected max
    within ``CALIB_EMAX_TOL``, the kernels' run launching the
    fused GEMM and its stats assembly only (the no-cache forward attends
    through plain ``blockwise_attention``). Prints the GEMMs at the top code
    and the names whose evaluation absmax passed the calibrated one (their
    codes clip). Then ``edge_deployment.main()`` on the card. Returns the
    phase's record with the edge study's."""
    import dataclasses

    import numpy as np

    from repro_torch import edge_deployment
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import forward, input_batch
    from repro_torch.quant.calibration import calibrating, static_scales
    from repro_torch.quant.stats import collecting

    t_phase = _phase_start(torch, "calibrate_static")["t0"]
    cfg = get_config(CALIB_ARCH)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", quant_policy=CALIB_POLICY)
    rc_s = dataclasses.replace(rc, quant_policy=CALIB_POLICY + ":stats")
    params = _init_on_card(torch, cfg, rc, "init_calibrate")

    def batch(seed):
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 64))
        return input_batch(cfg, torch.from_numpy(toks).to(DEVICE))

    with torch.no_grad():
        with calibrating() as reg:
            forward(cfg, rc, params, batch(13), impl="cuda")
        torch.cuda.synchronize()
        ops.reset_counts()
        with calibrating() as seen, static_scales(reg), collecting() as col_k:
            h_k, _, _ = forward(cfg, rc_s, params, batch(14), impl="cuda")
        torch.cuda.synchronize()
        counts = ops.kernel_counts()
        with static_scales(reg), collecting() as col_t:
            h_t, _, _ = forward(cfg, rc_s, params, batch(14), impl="torch")
    names = ("attn.q", "attn.k", "attn.v")
    first_k, first_t = _first_records(col_k, names), _first_records(col_t, names)
    e_k, e_t = col_k.profile().expected_max(), col_t.profile().expected_max()
    hk, ht = h_k.float(), h_t.float()
    rec = {"phase": "calibrate_static", "arch": cfg.name, "layers": cfg.num_layers,
           "policy": CALIB_POLICY, "registry": dict(reg), "gemms": len(col_k.records),
           "layer0_records": {n: dataclasses.asdict(r) for n, r in first_k.items()},
           "layer0_identical": all(first_k[n] == first_t[n] for n in names),
           "records_identical": col_k.records == col_t.records,
           "first_differing_record": next(
               (dataclasses.asdict(a) | {"plain": dataclasses.asdict(b)}
                for a, b in zip(col_k.records, col_t.records) if a != b), None),
           "expected_max": e_k, "expected_max_plain": e_t, "tol_expected_max": CALIB_EMAX_TOL,
           # a negative code clips to -128, so a clipped GEMM's max |q| is 127 or 128
           "gemms_at_top_code": sum(r.max_abs >= 127 for r in col_k.records),
           "gemms_below_top_code": sum(r.max_abs < 127 for r in col_k.records),
           "names_beyond_registry": sorted(n for n in seen if seen[n] > reg[n]),
           "hidden_rel_l2": ((hk - ht).norm() / ht.norm()).item(),
           "finite": bool(hk.isfinite().all()), "kernel_counts": counts}
    emit(rec)
    print(f"[calibrate_static] {rec['gemms_at_top_code']} of {rec['gemms']} GEMMs at the top "
          f"code (clipped or exactly at it); names whose evaluation absmax passed the "
          f"calibrated one: {rec['names_beyond_registry']}", flush=True)
    ran = {k for k, c in counts.items() if c["launches"] > 0}
    if not (rec["layer0_identical"] and rec["records_identical"]
            and len(col_t.records) == rec["gemms"] and abs(e_k - e_t) <= CALIB_EMAX_TOL
            and rec["finite"] and rec["gemms"] == 7 * cfg.num_layers
            and rec["gemms_below_top_code"] > 0):
        raise AssertionError(f"calibrate_static: kernels and plain versions disagree: {rec}")
    if ran != ENGINE_KERNELS or any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"calibrate_static did not run only the fused GEMM and its "
                             f"stats: {counts}")
    del params, h_k, h_t, hk, ht
    free_device_memory(torch)
    ops.reset_counts()
    t0 = time.perf_counter()
    edge = edge_deployment.main()
    torch.cuda.synchronize()
    counts_e = ops.kernel_counts()
    rec_e = {"phase": "edge_deployment",
             "cosine": {str(b): c for b, c in edge["cosine"].items()},
             "expected_max": {str(b): p.profile().expected_max()
                              for b, p in edge["profiles"].items()},
             "kernel_counts": counts_e, "seconds": time.perf_counter() - t0,
             "calibrate_seconds": t0 - t_phase}
    emit(rec_e)
    if counts_e["tugemm_fused"]["launches"] <= 0 or any(
            c["plain_calls"] for c in counts_e.values()):
        raise AssertionError(f"edge_deployment did not run on the kernels: {counts_e}")
    return {**rec, "edge": rec_e}


def dense_arch_phases(torch):
    """The group of the CLI / dense-archs / static-scale slice:
    ``check_dense_widths``, the two CLI serves, qwen3-14b's step parity and
    serve, ``calibrate_static`` and the edge study. Returns (GEMM records,
    attention records, {phase: (ticks, counts)}, calibrate record)."""
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=DEVICE)
    gemms, attn = check_dense_widths(torch, flush)
    del flush
    serves = {}
    for phase, arch in CLI_PHASES:
        serves[phase], _ = serve_cli(torch, phase, arch)
    serves.update(serve_qwen3_14b(torch))
    calib = calibrate_static(torch)
    return gemms, attn, serves, calib


def dense_entry(gemms: list) -> dict:
    """The kernels line's numbers of ``tugemm_fused`` at the dense archs'
    widths: one layer of each arch (its distinct widths, at the bits POLICY
    gives them) at M = 64 and 4, quantized on load (``dynamic``) and its
    int2 widths from packed planes (``packed``)."""
    out = {}
    for arch in DENSE_ARCHS:
        for M in (64, 4):
            for mode in ("dynamic", "packed"):
                rows = [r for r in gemms if r["model"] == arch and r["M"] == M
                        and r["case"].endswith(f" {mode}") and not r.get("static")]
                libs = [r["library_ms"] for r in rows]
                out[f"{arch} M={M} {mode}"] = {
                    "gemms": len(rows), "ms": sum(r["ms"] for r in rows),
                    "plain_ms": sum(r["plain_ms"] for r in rows),
                    "bound_ms": sum(r["bound_ms"] for r in rows),
                    "library_ms": None if None in libs else sum(libs), **device_entry(rows)}
    return out


def free_device_memory(torch) -> None:
    """Collect the reference cycles a Scheduler or Engine leaves (its
    registry's gauges close over it), so the weights they held go now."""
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------- the legacy Engine: SSM and hybrid
SSM_ARCH, HYBRID_ARCH = "falcon-mamba-7b", "hymba-1.5b"
SSM_POLICY = "ssm.*=int8,*=bf16"
HYBRID_POLICY = "attn.*=int8,ssm.*=int8,mlp.*=int2,*=bf16"
LONG_CAPACITY = 1152          # the long request's pool: 1,100 prompt + 16 new tokens fit
ENGINE_KERNELS = {"tugemm_fused", "tugemm_stats"}


# the Engine serves: one wave of 4 of the serve phase's 8 requests (for the
# script's time limit)
ENGINE_REQUESTS = 4


def engine_requests(cfg) -> list:
    """The first ``ENGINE_REQUESTS`` of the serve phase's requests (32-128
    prompt tokens from numpy seed 0, 16 new tokens each) as (prompt,
    max_new)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(32, 129))).tolist(), 16)
            for _ in range(ENGINE_REQUESTS)]


def model_setup_engine(torch, arch: str, policy: str, kv_cache_dtype: str = "bfloat16"):
    """``arch`` at full width on the dense layout, bf16 weights drawn on the
    card by a CUDA generator seeded 0."""
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.models import init

    cfg = get_config(arch)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", quant_policy=policy,
                   kv_cache_dtype=kv_cache_dtype, kv_layout="dense")
    t0 = time.perf_counter()
    params = init(cfg, rc, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    torch.cuda.synchronize()
    emit({"phase": f"init_{arch}", "arch": arch, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_inner": cfg.d_inner, "seconds": time.perf_counter() - t0,
          "params": sum(t.numel() for t in _leaves(params)),
          "weight_gb": sum(nbytes(t) for t in _leaves(params)) / 1e9,
          "device_bytes": torch.cuda.memory_allocated()})
    return cfg, rc, params


def engine_serve(torch, cfg, rc, params, impl: str, reqs, *, capacity: int, max_batch: int):
    """``reqs`` through a ``serve.Engine`` (track_energy) on ``impl``. The
    kernel counters are zeroed just before ``run`` and read just after; each
    prefill's and decode step's wrapper launches are counted around its
    call. Returns (record, {rid: tokens}, {rid: cycles_by_bits})."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, Request

    eng = Engine(cfg, rc, params, capacity=capacity, max_batch=max_batch, track_energy=True,
                 device=DEVICE, impl=impl)
    launches = {"prefill": [], "decode": []}

    def counted(fn, phase):
        def run(*a):
            before = sum(c["launches"] for c in ops.kernel_counts().values())
            out = fn(*a)
            launches[phase].append(sum(c["launches"] for c in ops.kernel_counts().values())
                                   - before)
            return out
        return run

    eng._prefill, eng._decode = counted(eng._prefill, "prefill"), counted(eng._decode, "decode")
    for rid, (p, n) in enumerate(reqs):
        eng.submit(Request(rid=rid, prompt=list(p), max_new=n))
    torch.cuda.synchronize()
    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = {r.rid: list(r.out) for r in done}
    energy = {e["rid"]: e["cycles_by_bits"] for e in eng.energy_summary()}
    gen = sum(len(o) for o in outs.values())
    cyc: dict = {}
    for c in energy.values():
        for b, v in c.items():
            cyc[str(b)] = cyc.get(str(b), 0) + v
    rec = {"impl": impl, "requests": len(done), "prompt_tokens": sum(len(p) for p, _ in reqs),
            "generated_tokens": gen, "wall_s": wall, "tokens_per_s": gen / wall,
            "decode_steps": len(eng.step_seconds),
            "median_step_ms": statistics.median(eng.step_seconds) * 1e3,
            "prefill_ms": [t * 1e3 for t in eng.prefill_seconds],
            "launches_per_decode_step": statistics.mean(launches["decode"]),
            "launches_per_prefill": statistics.mean(launches["prefill"]),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "kernel_counts": ops.kernel_counts(), "paths": ops.path_counts(),
            "cycles_by_bits": cyc}
    return rec, outs, energy


def serve_engine_pair(torch, phase, cfg, rc, params, reqs, bits: set, *, capacity: int,
                      max_batch: int) -> dict:
    """One Engine serve through the kernels, then through the plain versions:
    greedy tokens and per-request ``cycles_by_bits`` identical (the only
    code that differs is the fused GEMM and its stats, bit-exact against
    their plain versions), every request finished with its tokens in the
    vocabulary and cycles at exactly ``bits``; on the kernel serve only
    ``tugemm_fused`` and ``tugemm_stats`` launch (no plain call, every call
    site on the cuda route, ``flash_paged_decode`` not at all), on the
    plain serve none. Returns the kernel serve's record."""
    k, outs, energy = engine_serve(torch, cfg, rc, params, "auto", reqs, capacity=capacity,
                                   max_batch=max_batch)
    p, p_outs, p_energy = engine_serve(torch, cfg, rc, params, "torch", reqs,
                                       capacity=capacity, max_batch=max_batch)
    same = sum(a == b for r in outs for a, b in zip(outs[r], p_outs.get(r, [])))
    gen = k["generated_tokens"]
    rec = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "policy": rc.quant_policy,
           "kv_cache_dtype": rc.kv_cache_dtype, "capacity": capacity, "max_batch": max_batch,
           "weight_gb": sum(nbytes(t) for t in _leaves(params)) / 1e9, **k,
           "plain": {n: p[n] for n in ("wall_s", "tokens_per_s", "median_step_ms",
                                       "kernel_counts", "cycles_by_bits")},
           "tokens_equal_plain": same, "cycles_equal_plain": energy == p_energy}
    emit(rec)
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[r]) != n for r, (_, n) in enumerate(reqs)):
        raise AssertionError(f"{phase}: not every request finished with its tokens: {outs}")
    if any(not 0 <= t < cfg.vocab_size for o in outs.values() for t in o):
        raise AssertionError(f"{phase}: a token outside the vocabulary")
    if any(set(c) != bits or min(c.values()) <= 0 for c in energy.values()):
        raise AssertionError(f"{phase}: cycle totals not at bits {bits}: {energy}")
    if outs != p_outs or energy != p_energy:
        raise AssertionError(f"{phase}: the kernel serve's tokens or cycles differ from the "
                             f"plain serve's ({same} of {gen} tokens equal)")
    counts = k["kernel_counts"]
    ran = {n for n, c in counts.items() if c["launches"] > 0}
    routes = {r for v in k["paths"].values() for r in v}
    if ran != ENGINE_KERNELS or any(c["plain_calls"] for c in counts.values()) \
            or routes != {"cuda"}:
        raise AssertionError(f"{phase} did not run only the fused GEMM and its stats on the "
                             f"cuda route: {counts} {k['paths']}")
    if any(c["launches"] for c in p["kernel_counts"].values()):
        raise AssertionError(f"{phase}: the plain serve launched a kernel: {p['kernel_counts']}")
    return rec


def serve_engine_phases(torch) -> dict:
    """The legacy Engine at full width: ``serve_ssm`` (falcon-mamba-7b, 64
    layers, ``SSM_POLICY``) and ``serve_hybrid`` (hymba-1.5b, 32 layers,
    ``HYBRID_POLICY``, int8 dense KV) on ``ENGINE_REQUESTS`` of the serve
    phase's requests, then
    ``serve_hybrid_long``: one 1,100-token prompt and 16 new tokens at
    capacity 1,152, through the 1024-token sliding window of 29 of the 32
    layers and ``blockwise_attention``'s second KV chunk. Each serve runs
    through the kernels and the plain versions (``serve_engine_pair``).
    Returns {phase: record}."""
    import numpy as np

    out = {}
    cfg, rc, params = model_setup_engine(torch, SSM_ARCH, SSM_POLICY)
    out["serve_ssm"] = serve_engine_pair(torch, "serve_ssm", cfg, rc, params,
                                         engine_requests(cfg), {8}, capacity=256, max_batch=4)
    del params
    free_device_memory(torch)
    cfg, rc, params = model_setup_engine(torch, HYBRID_ARCH, HYBRID_POLICY, "int8")
    out["serve_hybrid"] = serve_engine_pair(torch, "serve_hybrid", cfg, rc, params,
                                            engine_requests(cfg), {8, 2}, capacity=256,
                                            max_batch=4)
    long = [(np.random.default_rng(1).integers(0, cfg.vocab_size, LONG_PROMPT).tolist(), 16)]
    out["serve_hybrid_long"] = serve_engine_pair(torch, "serve_hybrid_long", cfg, rc, params,
                                                 long, {8, 2}, capacity=LONG_CAPACITY,
                                                 max_batch=1)
    del params
    free_device_memory(torch)
    return out


def serve_dense(torch, cfg, rc, params, paged_outs: dict):
    """The paged-pool Scheduler on ``kv_layout="dense"`` (one KV row per
    slot, no block tables, attention through ``blockwise_attention``) on
    the serve phase's requests and weights: only the fused GEMM and its
    stats launch, no plain call. Its tokens against the paged serve's are
    printed, not gated: the paged serve attends through
    ``flash_paged_decode``, another float order."""
    import dataclasses

    rc_d = dataclasses.replace(rc, kv_layout="dense")
    sched, done, wall, counts, prompts = serve(torch, cfg, rc_d, params, "auto")
    outs = check_served(cfg, sched, done, prompts, {8, 2})
    rec = serve_record("serve_dense", sched, done, wall, counts, prompts)
    gen = sum(len(o) for o in outs.values())
    rec.update(tokens_equal_paged=sum(a == b for r in outs for a, b in
                                      zip(outs[r], paged_outs[r])),
               tokens=gen, cache_stats=sched.cache_stats())
    emit(rec)
    ran = {k for k, c in counts.items() if c["launches"] > 0}
    if ran != ENGINE_KERNELS or any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"serve_dense did not run only the fused GEMM and its stats: "
                             f"{counts}")
    return sched, counts


def ssm_entry(ssm_gemm: list) -> dict:
    """The kernels line's numbers of ``tugemm_fused`` at the SSM and hybrid
    widths: one layer's GEMMs of each model at decode (M=4) and at a
    128-token prefill, at the bits its serve policy gives them."""
    layers = {"falcon-mamba-7b": [("ssm.in_proj", 8), ("ssm.x_proj", 8), ("ssm.dt", 8),
                                  ("ssm.out_proj", 8)],
              "hymba-1.5b": [("ssm.in_proj", 8), ("ssm.x_proj", 8), ("ssm.dt", 8),
                             ("ssm.out_proj", 8), ("attn.q/o", 8), ("attn.k/v", 8),
                             ("attn.k/v", 8), ("attn.q/o", 8), ("mlp.gate/up", 2),
                             ("mlp.gate/up", 2), ("mlp.down", 2)]}
    out = {}
    for model, gemms in layers.items():
        for M in (4, 128):
            rows = [next(r for r in ssm_gemm if r["case"] == f"{model} {n}" and r["M"] == M
                         and r["bits"] == b) for n, b in gemms]
            libs = [r["library_ms"] for r in rows]
            out[f"{model} M={M}"] = {
                "gemms": len(rows), "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "library_ms": None if None in libs else sum(libs), **device_entry(rows)}
    return out


def expert_entry(moe_gemm: list, moe_serves: dict) -> dict:
    """The kernels line's expert-axis numbers of ``tugemm_fused``: one MoE
    layer's three expert GEMMs (gate, up, down: 64 experts, M=16, int2) per
    weight form, each one launch over all experts; library ``torch.bmm``."""
    out = {}
    for form in ("dynamic", "packed"):
        rows = [next(r for r in moe_gemm if r["case"] == f"{n} {form}")
                for n in ("moe.gate/up", "moe.gate/up", "moe.down")]
        out[form] = {
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": sum(r["library_ms"] for r in rows), **device_entry(rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "launches_a_call": rows[0]["launches_a_call"]["tugemm_fused"]}
    out["shape"] = ("one deepseek-v2-lite MoE layer's 3 expert GEMMs (gate, up 2048->1408, "
                    "down 1408->2048) over 64 experts at M=16, int2, with stats; dynamic: W "
                    "bf16 quantized on load; packed: int2 planes")
    return out


def expert_int_entry(moe_int: list, kernel: str) -> dict:
    """The kernels line's expert-axis numbers of ``tugemm_int8`` (with its
    stats) or ``tugemm_packed``: one MoE layer's three expert GEMMs (64
    experts, M=16, int2 codes), each one launch over all experts; library
    ``torch.bmm`` on the bf16 operands."""
    rows = [next(r for r in moe_int if r["kernel"] == kernel and r["case"].startswith(n))
            for n in ("moe.gate/up", "moe.gate/up", "moe.down")]
    return {"ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": sum(r["library_ms"] for r in rows), **device_entry(rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "launches_a_call": rows[0]["launches_a_call"][kernel],
            "shape": "one deepseek-v2-lite MoE layer's 3 expert GEMMs (gate, up 2048->1408, "
                     "down 1408->2048) over 64 experts at M=16 on int2 codes, "
                     + ("int8 carriers with stats" if kernel == "tugemm_int8"
                        else "packed int2 planes")}


# ------------------------------------------------------------------ training
# qwen3-0.6b at full width (28 layers, d 1024, vocab 151,936, tied
# embeddings) trained through ``repro_torch.launch.train``: bf16, remat
# ``block``, 8 x 512 tokens a step, lr 1e-3 (warmup 3 steps, cosine to 30)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 512, 8, 1e-3
TRAIN_STEPS, TRAIN_INT8_STEPS = 15, 10      # 15, not 30: the script's time limit
TRAIN_DROP = 0.5               # nats: the last 5 steps' mean loss below the first 5's
RESUME_LAYERS, RESUME_SEQ, RESUME_BATCH = 4, 256, 4   # train_resume: depth cut, full width
PARITY_LAYERS, PARITY_SEQ, PARITY_BATCH = 2, 64, 2    # train_parity_f32: card vs host
PARITY_LOSS_TOL, PARITY_PARAM_TOL = 1e-5, 1e-4        # relative; each leaf's relative L2
BF16_FLOPS_PER_S = H100.peak_flops
TRAIN_CKPT = os.path.join(HERE, "build", "train_ckpt")


def _phase_start(torch, phase: str) -> dict:
    """A phase's record: the bytes allocated on the card as it starts (also
    printed at once, on a line of its own), its peak counter reset, its
    clock started."""
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    emit({"phase": phase + "_start", "memory_allocated_gb": allocated / 1e9})
    return {"phase": phase, "memory_allocated_at_start_gb": allocated / 1e9,
            "t0": time.perf_counter()}


def _train_emit(torch, rec: dict, smi: str) -> None:
    rec["seconds"] = time.perf_counter() - rec.pop("t0")
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["card"] = smi
    emit(rec)


def _history_gates(phase: str, hist: list, window: int, drop: float) -> tuple:
    """Loss and grad norm finite at every step, and the last ``window``
    steps' mean loss at least ``drop`` below the first ``window``'s."""
    import math

    bad = [h["step"] for h in hist if not (math.isfinite(h["loss"])
                                           and math.isfinite(h["grad_norm"]))]
    if bad:
        raise AssertionError(f"{phase}: loss or grad norm not finite at steps {bad}")
    first = statistics.mean(h["loss"] for h in hist[:window])
    last = statistics.mean(h["loss"] for h in hist[-window:])
    if not last <= first - drop:
        raise AssertionError(f"{phase}: mean loss {first} over the first {window} steps, "
                             f"{last} over the last {window}: not {drop} nats lower")
    return first, last


def _train_argv(steps: int, *extra) -> list:
    return ["--arch", ARCH, "--device", DEVICE, "--remat", "block", "--seq-len", str(TRAIN_SEQ),
            "--global-batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR), "--steps", str(steps),
            *extra]


def _history_record(trainer, cfg, seq: int, batch: int) -> dict:
    """Losses, grad norms, step ms and the throughput numbers of a run."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import count_params, model_flops

    hist = trainer.history
    clock = trainer.clock.summary()
    tokens = seq * batch
    flops = model_flops(cfg, ShapeConfig("train", seq, batch, "train"))
    steady = [h["ms"] for h in hist[1:]] or [hist[0]["ms"]]
    return {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "params": count_params(cfg), "seq_len": seq,
            "global_batch": batch, "steps": len(hist), "dtype": trainer.rc.dtype,
            "remat": trainer.rc.remat, "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist], "step_ms": [h["ms"] for h in hist],
            "step_p50_ms": clock["p50_ms"], "step_p99_ms": clock["p99_ms"],
            "stragglers": clock["stragglers"], "tokens_per_step": tokens,
            "tokens_per_s": tokens / (clock["p50_ms"] / 1e3),
            "tokens_per_s_after_step_1": tokens * len(steady) / (sum(steady) / 1e3),
            "model_flops_per_step": flops,
            "bf16_peak_share": flops / (clock["p50_ms"] / 1e3) / BF16_FLOPS_PER_S}


def train_dense(torch, smi: str):
    """``launch.train.main`` on qwen3-0.6b at full width for ``TRAIN_STEPS``
    steps with a checkpoint directory (no tuGEMM kernel launches: the bf16
    GEMMs are ``torch.matmul``); returns (cfg, the trained params,
    detached)."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.tree import tree_map

    rec = _phase_start(torch, "train_dense")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    ops.reset_counts()
    trainer = train_main(_train_argv(TRAIN_STEPS, "--ckpt-dir", TRAIN_CKPT))
    launched = {k: c for k, c in ops.kernel_counts().items() if c["launches"]}
    if launched:
        raise AssertionError(f"train_dense launched tuGEMM kernels: {launched}")
    first, last = _history_gates("train_dense", trainer.history, 5, TRAIN_DROP)
    rec.update(_history_record(trainer, trainer.cfg, TRAIN_SEQ, TRAIN_BATCH),
               loss_first5=first, loss_last5=last, gate_drop_nats=TRAIN_DROP,
               kernel_launches=0,
               checkpoint_bytes=sum(os.path.getsize(os.path.join(dp, f))
                                    for dp, _, fs in os.walk(TRAIN_CKPT) for f in fs))
    cfg, params = trainer.cfg, tree_map(lambda t: t.detach(), trainer.state["params"])
    del trainer
    _train_emit(torch, rec, smi)
    return cfg, params


def train_then_serve(torch, cfg, rc, trained, smi: str, phase: str = "train_then_serve",
                     ckpt_dir: str = TRAIN_CKPT) -> None:
    """Restore the last checkpoint in ``ckpt_dir`` (``train_dense``'s, or
    ``train_mesh``'s) and serve 4 requests with ``ROBUST_POLICY`` on the
    kernels: the restored weights bit for bit the trained ones, and greedy
    tokens and ``cycles_by_bits`` equal to a serve of the trained weights
    held in memory."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import leaves

    rec = _phase_start(torch, phase)
    step = ckpt.latest_step(ckpt_dir)
    restored, _ = ckpt.restore(ckpt_dir, step, {"params": trained})
    restored = restored["params"]
    same = all(torch.equal(a, b) for a, b in zip(leaves(trained), leaves(restored)))
    rc_s = dataclasses.replace(rc, quant_policy=ROBUST_POLICY)
    runs = {}
    for name, params in (("in_memory", trained), ("restored", restored)):
        sched, done, wall, counts, prompts = serve(torch, cfg, rc_s, params, "auto", requests=4)
        runs[name] = (check_served(cfg, sched, done, prompts, {8, 2}),
                      dict(sched.cycles_by_bits), counts, wall)
        _only_fused_on_cuda(f"{phase} ({name})", counts, ops.path_counts())
    (out_m, cyc_m, counts_m, wall_m), (out_r, cyc_r, _, wall_r) = runs["in_memory"], runs["restored"]
    rec.update(checkpoint_step=step, restored_bitwise=same, tokens_equal=out_m == out_r,
               cycles_equal=cyc_m == cyc_r, policy=ROBUST_POLICY, requests=len(out_m),
               cycles_by_bits={str(b): d for b, d in sorted(cyc_m.items())},
               kernel_counts=counts_m, wall_s={"in_memory": wall_m, "restored": wall_r})
    _train_emit(torch, rec, smi)
    if not (same and out_m == out_r and cyc_m == cyc_r):
        raise AssertionError(f"{phase}: the restored checkpoint serves other tokens "
                             f"or cycles than the trained weights: {rec}")


def train_int8_state(torch, smi: str) -> None:
    """``--moments int8 --grad-compression int8_ef`` for ``TRAIN_INT8_STEPS``
    steps: finite, the loss falling; the optimizer state's bytes against f32
    moments'."""
    from repro_torch.launch.train import main as train_main
    from repro_torch.tree import leaves

    rec = _phase_start(torch, "train_int8_state")
    trainer = train_main(_train_argv(TRAIN_INT8_STEPS, "--moments", "int8",
                                     "--grad-compression", "int8_ef"))
    first, last = _history_gates("train_int8_state", trainer.history, 3, 0.0)
    opt, params = trainer.state["opt"], leaves(trainer.state["params"])

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))

    n = sum(p.numel() for p in params)
    rec.update(_history_record(trainer, trainer.cfg, TRAIN_SEQ, TRAIN_BATCH),
               loss_first3=first, loss_last3=last,
               moments_bytes=nbytes(opt.m) + nbytes(opt.v), f32_moments_bytes=8 * n,
               master_bytes=nbytes(opt.master), ef_bytes=nbytes(trainer.state["ef"]),
               param_bytes=sum(p.numel() * p.element_size() for p in params))
    rec["moments_share_of_f32"] = rec["moments_bytes"] / rec["f32_moments_bytes"]
    del trainer, opt, params
    _train_emit(torch, rec, smi)


def train_resume(torch, smi: str) -> None:
    """qwen3-0.6b cut to ``RESUME_LAYERS`` layers at full width, under
    deterministic algorithms: 6 steps straight, against 3 steps, an
    ``InjectedFailure`` at step 4, a resume from the step-3 checkpoint and 3
    more steps. Every leaf of the state (parameters, master weights,
    moments, step) bit for bit."""
    import shutil
    import warnings

    from repro_torch.configs.base import RunConfig, ShapeConfig, get_config
    from repro_torch.data import make_batches
    from repro_torch.train import InjectedFailure, Trainer
    from repro_torch.tree import leaves

    rec = _phase_start(torch, "train_resume")
    cfg = get_config(ARCH).replace(num_layers=RESUME_LAYERS)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat="block", lr=TRAIN_LR,
                   warmup_steps=1, total_steps=6)
    shape = ShapeConfig("resume", RESUME_SEQ, RESUME_BATCH, "train")
    d_crash = TRAIN_CKPT + "_crash"
    shutil.rmtree(d_crash, ignore_errors=True)

    def trainer(d, **kw):
        return Trainer(cfg, rc, ckpt_dir=d, ckpt_every=3, device=DEVICE,
                       log_fn=lambda *a: None, **kw)

    def run(t, steps, start=0):
        it = make_batches(cfg, shape, seed=2, start_step=start)
        try:
            t.run(it, steps)
        finally:
            it.close()

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t = trainer(None)
            run(t, 6)
            full = [x.detach().clone() for x in leaves(t.state)]
            losses = [h["loss"] for h in t.history]
            del t
            t = trainer(d_crash, fail_at_step=4)
            try:
                run(t, 6)
                failed = False
            except InjectedFailure:
                failed = True
            t.saver.wait()
            del t
            t = trainer(d_crash)
            resumed_at = t.step
            run(t, 3, start=3)
            equal = [torch.equal(a, b.detach()) for a, b in zip(full, leaves(t.state))]
            losses_resumed = [h["loss"] for h in t.history]
            del t
    finally:
        torch.use_deterministic_algorithms(prev)
    shutil.rmtree(d_crash, ignore_errors=True)
    rec.update(layers=RESUME_LAYERS, seq_len=RESUME_SEQ, global_batch=RESUME_BATCH,
               injected_failure_raised=failed, resumed_at_step=resumed_at,
               leaves=len(equal), leaves_bitwise_equal=sum(equal), losses=losses,
               losses_after_resume=losses_resumed,
               nondeterminism_warnings=sorted({str(w.message)[:200] for w in caught
                                               if "determinis" in str(w.message)}))
    _train_emit(torch, rec, smi)
    if not (failed and resumed_at == 3 and all(equal)):
        raise AssertionError(f"train_resume: the resumed run is not bit for bit the straight "
                             f"run: {rec}")


def train_parity_f32(torch, smi: str) -> None:
    """One f32 train step of qwen3-0.6b cut to ``PARITY_LAYERS`` layers at
    full width on ``PARITY_BATCH`` x ``PARITY_SEQ`` tokens, on the card and
    on the host from the same weights and batch: the loss to
    ``PARITY_LOSS_TOL`` relative, every parameter leaf after the step to
    ``PARITY_PARAM_TOL`` relative L2."""
    from repro_torch.configs.base import RunConfig, ShapeConfig, get_config
    from repro_torch.data import make_batches
    from repro_torch.models import init
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import leaves_with_paths, tree_map

    rec = _phase_start(torch, "train_parity_f32")
    cfg = get_config(ARCH).replace(num_layers=PARITY_LAYERS)
    rc = RunConfig(dtype="float32", param_dtype="float32", remat="none", lr=TRAIN_LR,
                   warmup_steps=1, total_steps=10)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        host = init(cfg, rc, torch.Generator().manual_seed(0), device="cpu")
        card = tree_map(lambda t: t.to(DEVICE, copy=True), host)
        it = make_batches(cfg, ShapeConfig("parity", PARITY_SEQ, PARITY_BATCH, "train"), seed=0)
        batch = next(it)
        it.close()
        out = {}
        for side, params, dev in (("card", card, DEVICE), ("host", host, "cpu")):
            t0 = time.perf_counter()
            state, m = build_train_step(cfg, rc)(init_train_state(cfg, rc, params),
                                                 {k: v.to(dev) for k, v in batch.items()})
            out[side] = (float(m["loss"]), float(m["grad_norm"]),
                         {n: t.detach().to("cpu", torch.float64)
                          for n, t in leaves_with_paths(state["params"])},
                         time.perf_counter() - t0)
            del state
    finally:
        torch.set_float32_matmul_precision(prev)
    (lc, gc_, pc, sc), (lh, gh, ph, sh) = out["card"], out["host"]
    errs = {n: float(torch.linalg.vector_norm(pc[n] - ph[n])
                     / torch.clamp_min(torch.linalg.vector_norm(ph[n]), 1e-30)) for n in ph}
    worst = max(errs, key=errs.get)
    rec.update(layers=PARITY_LAYERS, tokens=PARITY_BATCH * PARITY_SEQ, loss_card=lc,
               loss_host=lh, loss_rel_err=abs(lc - lh) / abs(lh), grad_norm_card=gc_,
               grad_norm_host=gh, param_rel_l2=errs, worst_leaf=worst,
               worst_rel_l2=errs[worst], loss_tol=PARITY_LOSS_TOL, param_tol=PARITY_PARAM_TOL,
               step_seconds={"card": sc, "host": sh})
    _train_emit(torch, rec, smi)
    if rec["loss_rel_err"] > PARITY_LOSS_TOL or errs[worst] > PARITY_PARAM_TOL:
        raise AssertionError(f"train_parity_f32: card and host disagree: {rec}")


def train_refuses_quantized(torch, smi: str) -> None:
    """A ``*=int8`` train step on the card raises the kernels' RuntimeError
    (no TPU kernel has a backward) before any launch; the same weights'
    forward under ``torch.no_grad`` launches the fused GEMM."""
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import forward, init
    from repro_torch.train import build_train_step, init_train_state

    rec = _phase_start(torch, "train_refuses_quantized")
    cfg = get_config(ARCH).replace(num_layers=1)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat="none",
                   quant_policy="*=int8")
    params = init(cfg, rc, torch.Generator().manual_seed(0), device=DEVICE)
    state = init_train_state(cfg, rc, params)
    tokens = torch.arange(32, device=DEVICE, dtype=torch.int32).reshape(2, 16)
    ops.reset_counts()
    try:
        build_train_step(cfg, rc)(state, {"tokens": tokens, "labels": tokens})
        raised = None
    except RuntimeError as e:
        raised = str(e)
    refused_launches = ops.kernel_counts()["tugemm_fused"]["launches"]
    with torch.no_grad():
        forward(cfg, rc, params, {"tokens": tokens})
    torch.cuda.synchronize()
    served_launches = ops.kernel_counts()["tugemm_fused"]["launches"] - refused_launches
    rec.update(error=raised, launches_before_refusal=refused_launches,
               no_grad_forward_launches=served_launches)
    _train_emit(torch, rec, smi)
    if raised is None or "requires grad" not in raised or refused_launches:
        raise AssertionError(f"train_refuses_quantized: the int8 train step was not refused "
                             f"before a launch: {rec}")
    if served_launches <= 0:
        raise AssertionError("train_refuses_quantized: the no-grad forward launched no kernel")


def train_phases(torch, cfg, rc, smi: str) -> None:
    """The training phases, in order; ``cfg`` / ``rc`` are the serve phases'
    (``train_then_serve`` serves with them under ``ROBUST_POLICY``)."""
    import shutil

    tcfg, trained = train_dense(torch, smi)
    train_then_serve(torch, tcfg, rc, trained, smi)
    del trained
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    train_int8_state(torch, smi)
    train_resume(torch, smi)
    train_parity_f32(torch, smi)
    train_refuses_quantized(torch, smi)
    free_device_memory(torch)


# ------------------------------------------------------------ the dp x tp mesh
# qwen3-0.6b (full width and depth) and deepseek-v2-lite (full width, cut to
# MESH_MOE_LAYERS layers) served over a dp x tp mesh of dp*tp ranks. With
# fewer cards than ranks every rank runs on cuda:0 and the collectives go
# over gloo through host memory; with a card a rank, nccl.
MESH_DP, MESH_TP = 2, 4
MESH_DENSE_LAYERS = 8          # qwen3-0.6b: 28 -> 8 (the script's time limit)
MESH_MOE_LAYERS = 4
MESH_KERNELS = ("tugemm_fused", "tugemm_int8", "tugemm_stats", "flash_paged_decode")


def mesh_backend(torch, world: int = MESH_DP * MESH_TP) -> str:
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def check_mesh_rank(torch, flush):
    """Every kernel of the mesh path at the shapes one rank of
    ``serve_mesh`` launches (qwen3-0.6b at dp=2, tp=4: 2 of the 4 rows, so
    M = 2 x 16 on a prefill tick), against its plain version: the
    column-parallel fused GEMMs at N/tp, bit for bit; the gathered GEMMs
    (attn.o, mlp.down) as the int8 GEMM with its stats on the full-K plane,
    exactly; attention over the rank's rows and heads with the
    single-device launch's split plan (``plan_dims``), which must be the
    full launch's slice bit for bit (GQA: 2 of 8 kv heads; MLA: 4 of 16
    heads on the replicated latent), and within ``ATTN_TOL`` of its plain
    version. Every case's device time is read by the last phase."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_paged import flash_paged_decode, split_plan
    from repro_torch.kernels.unary_stats import HDR
    from repro_torch.quant.quantize import compute_scale

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16
    B, W = 4, 16
    M = B // MESH_DP * W
    out = []
    for case, K, N, bits in (("attn.q", 1024, 2048, 8), ("attn.k/v", 1024, 1024, 8),
                             ("mlp.gate/up", 1024, 3072, 2)):
        x = torch.randn(M, K, device=dev, generator=gen).to(bf16)
        w = (torch.randn(K, N // MESH_TP, device=dev, generator=gen) * 0.02).to(bf16)
        sx, sw = compute_scale(x, bits), compute_scale(w, bits, axis=1)
        xq, wq = int8_operands(torch, x, w, sx, sw, bits)
        out.append(fused_case(torch, "check_mesh_rank", f"{case} N/tp", x, w, sx, sw, bits,
                              False, lib_int_mm(torch, xq, wq), flush, mesh_rank=True))
    for case, K, bits in (("attn.o", 2048, 8), ("mlp.down", 3072, 2)):
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
        a = torch.randint(lo, hi, (M, K), device=dev, generator=gen, dtype=torch.int8)
        b = torch.randint(lo, hi, (K, 1024), device=dev, generator=gen, dtype=torch.int8)
        call = lambda a=a, b=b: ops.matmul_int8(a, b, collect_stats=True, impl="cuda")
        got, want = call(), ops.matmul_int8(a, b, collect_stats=True, impl="torch")
        torch.cuda.synchronize()
        exact, err = _exact(got, want)
        lib_call = lib_int_mm(torch, a, b)
        rec = dict(kernel="tugemm_int8", case=f"{case} gathered", M=M, K=K, N=1024, bits=bits,
                   stats=True, mesh_rank=True, **gemm_grid(M, 1024, K, 1), exact=exact,
                   max_abs_err=err, ms=median_ms(torch, call, flush=flush),
                   plain_ms=median_ms(torch, lambda a=a, b=b: ops.matmul_int8(
                       a, b, collect_stats=True, impl="torch"), flush=flush),
                   library_ms=None if lib_call is None else median_ms(torch, lib_call,
                                                                     flush=flush),
                   **_bound(nbytes(a, b) + 4 * M * 1024 + 4 * (2 * K + HDR + K),
                            2 * M * K * 1024))
        emit({"phase": "check_mesh_rank", **rec})
        if not exact:
            raise AssertionError(f"tugemm_int8 with stats disagrees with its plain version: {rec}")
        DEVICE_TIMED.append((rec, call, lib_call))
        out.append(rec)
    gqa = dict(kv=8, group=2, part_dims=(128,), hdv=128, bs=16, MB=16)
    mla = dict(kv=1, group=16, part_dims=(512, 64), hdv=512, bs=16, MB=16, alias_v=True)
    rows = [(112, 16), (143, 1), (0, 0), (60, 1)]
    for name, shape in (("gqa_mesh_rank_step16_int8", gqa), ("mla_mesh_rank_step16_int8", mla)):
        args = _attn_case(torch, gen, rows=rows, sq=W, kv_dtype=torch.int8, q_dtype=bf16,
                          **shape)
        q, kparts, kscales, v, vs, tables, pos, kv_len = args
        kv, H = shape["kv"], q.shape[2]
        full = flash_paged_decode(*args, kv_heads=kv, impl="cuda")
        bl = B // MESH_DP
        for d, t in ((0, 0), (MESH_DP - 1, MESH_TP - 1)):
            r = slice(d * bl, (d + 1) * bl)
            hs = slice(t * H // MESH_TP, (t + 1) * H // MESH_TP)
            kv_l = kv // MESH_TP if kv > 1 else 1

            def heads(p):
                if kv == 1:
                    return p
                f = p.shape[2] // kv
                return p[:, :, t * kv_l * f:(t + 1) * kv_l * f].contiguous()

            rargs = (q[r, :, hs].contiguous(), tuple(heads(p) for p in kparts), kscales,
                     kparts[0] if shape.get("alias_v") else heads(v), vs, tables[r].contiguous(),
                     pos[r].contiguous(), kv_len[r].contiguous())
            plan = (B, kv, H // kv * W)
            got = flash_paged_decode(*rargs, kv_heads=kv_l, impl="cuda", plan_dims=plan)
            own = flash_paged_decode(*rargs, kv_heads=kv_l, impl="cuda")
            torch.cuda.synchronize()
            sliced = torch.equal(got, full[r, :, hs])
            rec = dict(kernel="flash_paged_decode", case=name, rank=[d, t], B=bl, sq=W,
                       heads=H // MESH_TP, kv_heads=kv_l,
                       splits=split_plan(*plan, tables.shape[1], sms)[0],
                       own_plan_splits=split_plan(bl, kv_l, (H // MESH_TP) // kv_l * W,
                                                  tables.shape[1], sms)[0],
                       slice_of_full_launch=sliced,
                       own_plan_equal=torch.equal(own, full[r, :, hs]))
            emit({"phase": "check_mesh_rank", **rec})
            if not sliced:
                raise AssertionError(f"a rank's attention is not the full launch's slice: {rec}")
        # the rank's call against its plain version, timed
        kv_l = kv // MESH_TP if kv > 1 else 1
        rshape = dict(shape, kv=kv_l, group=H // MESH_TP // kv_l)
        rec = attn_check(torch, gen, sms, flush, name, rshape, rows[:bl], W, torch.int8, bf16,
                         None, phase="check_mesh_rank", plan_dims=(B, kv, H // kv * W))
        rec["mesh_rank"] = True
        out.append(rec)
    return out


def mesh_kernels_only(phase: str, by_rank: list) -> None:
    """Every rank launched each of the mesh path's kernels and made no
    plain call."""
    for rank, c in enumerate(by_rank):
        if any(c[k]["launches"] <= 0 for k in MESH_KERNELS) or any(
                v["plain_calls"] for v in c.values()):
            raise AssertionError(f"{phase}: rank {rank} did not run only the mesh kernels: {c}")


def serve_mesh(torch, phase, cfg, rc, source, want: dict, want_cycles: dict, smi: str,
               want_drops: int | None = None) -> dict:
    """The serve phase's requests on a ``MESH_DP`` x ``MESH_TP`` mesh, each
    rank drawing its own weight shard (``source``: an ``InitShards`` of the
    single-device weights). Gates: greedy tokens and ``cycles_by_bits`` equal
    to the single-device serve's (``want``, ``want_cycles``), and the MoE
    drops to ``want_drops``; ``device_attribution()`` of shape (dp, tp)
    summing exactly to the totals; every quantized collective's payload, by
    (label, bits), at most bits/16 of its bf16 equivalent; in every rank the
    four mesh kernels launching and no plain call. Prints the backend, the world size,
    tokens/s, tick p50 / p99 (each tick's main step, ``tick_seconds``), the
    wire bytes by bits against bf16 and the
    interconnect energy. Returns (ticks, {kernel: summed counts})."""
    import numpy as np

    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    backend = mesh_backend(torch)
    sched, prompts = serving_scheduler(cfg, rc, source, "auto",
                                       mesh=f"{MESH_DP},{MESH_TP}", mesh_backend=backend)
    setup_s = time.perf_counter() - t0
    sched.reset_rank_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    by_rank = sched.rank_kernel_counts()
    outs = {r.rid: list(r.out) for r in done}
    att = sched.device_attribution()
    comms = sched.comms_summary()
    ic = sched.interconnect_report()
    ticks = np.asarray(sched.tick_seconds) * 1e3
    gen = sum(len(o) for o in outs.values())
    counts = {k: {"launches": sum(c[k]["launches"] for c in by_rank),
                  "plain_calls": sum(c[k]["plain_calls"] for c in by_rank)} for k in by_rank[0]}
    rec = {"phase": phase, "nvidia_smi": smi, "backend": backend,
           "world": MESH_DP * MESH_TP, "dp": MESH_DP, "tp": MESH_TP,
           "ranks_on": "cuda:r" if backend == "nccl" else "cuda:0 (shared; collectives in shared host memory)",
           "arch": cfg.name, "layers": cfg.num_layers, "policy": rc.quant_policy,
           "setup_s": setup_s, "wall_s": wall, "tokens_per_s": gen / wall, "ticks": sched.ticks,
           "tick_ms_p50": float(np.percentile(ticks, 50)),
           "tick_ms_p99": float(np.percentile(ticks, 99)),
           "tokens_equal": sum(a == b for r in want for a, b in zip(want[r], outs.get(r, []))),
           "tokens": sum(len(o) for o in want.values()),
           "cycles_by_bits": {str(b): v for b, v in sorted(sched.cycles_by_bits.items())},
           "cycles_equal": sched.cycles_by_bits == want_cycles,
           "moe_dropped_tokens": sched.moe_dropped_tokens,
           "device_attribution": {str(b): a.tolist() for b, a in att.items()},
           "wire": {str(b): {"payload_bytes": r["payload_bytes"], "scale_bytes": r["scale_bytes"],
                             "bf16_bytes": r["bf16_bytes"], "calls": r["calls"]}
                    for b, r in sorted(comms["by_bits"].items())},
           "wire_bytes": comms["bytes_moved"], "wire_bf16_bytes": comms["bf16_bytes"],
           "interconnect_energy_j": ic["energy_j"],
           "rank_step_s": sched.health()["mesh"]["rank_step_s"],
           "rank_collective_s": sched.health()["mesh"]["rank_collective_s"],
           "interconnect_by_bits": {str(b): v for b, v in ic["by_bits"].items()},
           "kernel_counts": counts,
           "launches_by_rank": [{k: c[k]["launches"] for k in MESH_KERNELS} for c in by_rank]}
    emit(rec)
    sched.close()
    if outs != want or sched.cycles_by_bits != want_cycles:
        raise AssertionError(f"{phase}: tokens or cycles differ from the single-device serve")
    if want_drops is not None and sched.moe_dropped_tokens != want_drops:
        raise AssertionError(f"{phase}: {sched.moe_dropped_tokens} MoE drops, the single-device "
                             f"serve counted {want_drops}")
    for b, a in att.items():
        if a.shape != (MESH_DP, MESH_TP) or int(a.sum()) != sched.cycles_by_bits[b][
                "serial_cycles"]:
            raise AssertionError(f"{phase}: device attribution {a} does not sum to the totals")
    # every quantized collective at its bits/16 (each gathered GEMM's local
    # feature count packs here: 8 // bits divides it)
    quant = {k: r for k, r in sched.comms.items() if k[1] < 16}
    if not quant or any(r["payload_bytes"] * 16 > r["bf16_bytes"] * b
                        for (_, b), r in quant.items()):
        raise AssertionError(f"{phase}: quantized gathers above bits/16 of bf16: {quant}")
    mesh_kernels_only(phase, by_rank)
    ops.reset_counts()
    return {"ticks": sched.ticks, "counts": counts}


def mesh_entry(name: str, rank_rows: list, serves: dict) -> dict:
    """The kernels line's mesh numbers for ``name``: its launches in each
    mesh serve (summed over the ranks) and, where ``check_mesh_rank``
    checked it, each rank-shape case's times against its bound."""
    out = {"mesh_launches_by_path": {ph: r["counts"][name]["launches"]
                                     for ph, r in serves.items()}}
    rows = [r for r in rank_rows if r["kernel"] == name and "ms" in r]
    if rows:
        out["mesh_rank"] = {r["case"]: {k: r.get(k) for k in (
            "M", "K", "N", "bits", "B", "sq", "heads", "kv_heads", "splits", "max_abs_err", "ms",
            "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
            "bound_by")} for r in rows}
    return out


def serve_mesh_phases(torch, cfg, rc, smi: str) -> dict:
    """``serve_mesh``: qwen3-0.6b at full width cut to ``MESH_DENSE_LAYERS``
    layers, served on one card (``serve_mesh_single``) and over the mesh,
    from the CPU generator's weights (each rank draws them and keeps its
    shard). Then ``serve_mesh_moe``: deepseek-v2-lite at full width cut to
    ``MESH_MOE_LAYERS`` layers (1 dense + 3 MoE: 64 experts, 16 a rank),
    served on one card and over the mesh in this phase, from a CUDA
    generator's weights. The rank pool is stopped at the end."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import close_rank_pool
    from repro_torch.models import init
    from repro_torch.parallel.serve_mesh import InitShards

    t0 = time.perf_counter()
    dcfg = cfg.replace(num_layers=MESH_DENSE_LAYERS)
    params = init(dcfg, rc, torch.Generator().manual_seed(0), device=DEVICE)
    sched, done, wall, counts, prompts = serve(torch, dcfg, rc, params, "auto")
    want = check_served(dcfg, sched, done, prompts, {8, 2})
    rec = serve_record("serve_mesh_single", sched, done, wall, counts, prompts)
    rec.update(reduced={"num_layers": [cfg.num_layers, MESH_DENSE_LAYERS]},
               seconds=time.perf_counter() - t0)
    emit(rec)
    want_cycles = dict(sched.cycles_by_bits)
    del sched, params
    free_device_memory(torch)
    out = {"serve_mesh": serve_mesh(torch, "serve_mesh", dcfg, rc,
                                    InitShards(dcfg, rc, 0, "cpu"), want, want_cycles, smi)}
    t0 = time.perf_counter()
    mcfg = get_config(MOE_ARCH).replace(num_layers=MESH_MOE_LAYERS)
    mrc = dataclasses.replace(rc, quant_policy=MOE_POLICY)
    params = init(mcfg, mrc, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    sched, done, wall, counts, prompts = serve(torch, mcfg, mrc, params, "auto")
    single = check_served(mcfg, sched, done, prompts, {8, 2})
    rec = serve_record("serve_mesh_moe_single", sched, done, wall, counts, prompts)
    rec.update(reduced={"num_layers": [get_config(MOE_ARCH).num_layers, MESH_MOE_LAYERS]},
               seconds=time.perf_counter() - t0)
    emit(rec)
    want_moe, cyc_moe, drops = single, dict(sched.cycles_by_bits), sum(sched.tick_dropped_tokens)
    del sched
    serve_graphs(torch, "deepseek_4_layers", mcfg, mrc, params, {8, 2})
    del params
    free_device_memory(torch)
    out["serve_mesh_moe"] = serve_mesh(torch, "serve_mesh_moe", mcfg, mrc,
                                       InitShards(mcfg, mrc, 0, "cuda"), want_moe, cyc_moe, smi,
                                       want_drops=drops)
    close_rank_pool()
    return out


# ------------------------------------------------------- dp x tp training
# qwen3-0.6b and deepseek-v2-lite trained on a (data, model) mesh of ranks
# (``Trainer(mesh=)``: each rank holds its part of the train state and runs
# the sharded step of parallel/train_mesh.py). With fewer cards than ranks
# every rank runs on cuda:0 and the collectives go over gloo through host
# memory. No tuGEMM kernel runs: training is *=bf16 (quantized GEMMs have no
# backward, ROADMAP C14).
MESH_TRAIN = (2, 2)
MESH_TRAIN_STEPS = 10
MESH_TRAIN_LAYERS = 8          # train_mesh: qwen3-0.6b 28 -> 8 (the script's time limit)
MESH_MOE_STEPS, MESH_MOE_BATCH = 3, 4
MESH_PARITY_STEPS = 3
MESH_EF_PARAM_TOL = 2e-3       # int8 moments + int8_ef: one-ulp flips of EF codes, Adam-carried
MESH_CKPT = os.path.join(HERE, "build", "train_mesh_ckpt")


def _quiet(*_):
    pass


def _mesh_trainer(torch, cfg, rc, **kw):
    from repro_torch.train import Trainer

    return Trainer(cfg, rc, device=DEVICE, mesh=MESH_TRAIN, log_fn=_quiet,
                   mesh_backend=mesh_backend(torch, MESH_TRAIN[0] * MESH_TRAIN[1]), **kw)


def _mesh_rec(torch, rec: dict, trainer) -> dict:
    """The mesh's layout, and every rank's state bytes against its specs'
    share and the one-card state's, and its card peak; raises when a rank
    holds more than its share."""
    res = trainer.resident_bytes()
    rec.update(mesh={"data": MESH_TRAIN[0], "model": MESH_TRAIN[1]},
               backend=mesh_backend(torch, len(res)),
               ranks_on="cuda:r" if mesh_backend(torch, len(res)) == "nccl"
               else "cuda:0 (shared; collectives in shared host memory)",
               rank_state_bytes=[r["state_bytes"] for r in res],
               rank_share_bytes=[r["share_bytes"] for r in res],
               one_card_state_bytes=res[0]["one_process_bytes"],
               rank_peak_allocated_gb=[(r["peak_allocated_bytes"] or 0) / 1e9 for r in res])
    over = [i for i, r in enumerate(res) if r["state_bytes"] > r["share_bytes"]]
    if over:
        raise AssertionError(f"{rec['phase']}: ranks {over} hold more than their share: {res}")
    return rec


def _mesh_parity(torch, phase: str, cfg, rc, param_tol: float, smi: str, params=None,
                 generator="cpu"):
    """``MESH_PARITY_STEPS`` f32 steps on ``PARITY_BATCH`` x ``PARITY_SEQ``
    tokens, on one card and on the mesh from the same weights and batches:
    the loss to ``PARITY_LOSS_TOL`` relative, every gathered parameter leaf
    to ``param_tol`` relative L2."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batches
    from repro_torch.train import Trainer

    rec = _phase_start(torch, phase)
    it = make_batches(cfg, ShapeConfig("parity", PARITY_SEQ, PARITY_BATCH, "train"), seed=0)
    batches = [next(it) for _ in range(MESH_PARITY_STEPS)]
    it.close()
    one = Trainer(cfg, rc, device=DEVICE, log_fn=_quiet, params=params)
    one.run(iter(batches), MESH_PARITY_STEPS)
    want = {n: t.to("cpu", torch.float64) for n, t in one.gather_state("params").items()}
    loss_one = [h["loss"] for h in one.history]
    del one, params
    free_device_memory(torch)
    mt = _mesh_trainer(torch, cfg, rc, init_generator=generator)
    mt.run(iter(batches), MESH_PARITY_STEPS)
    got = {n: t.to(torch.float64) for n, t in mt.gather_state("params").items()}
    loss_mesh = [h["loss"] for h in mt.history]
    _mesh_rec(torch, rec, mt)
    mt.close()
    errs = {n: float(torch.linalg.vector_norm(got[n] - want[n])
                     / torch.clamp_min(torch.linalg.vector_norm(want[n]), 1e-30)) for n in want}
    worst = max(errs, key=errs.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_mesh, loss_one))
    rec.update(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, steps=MESH_PARITY_STEPS,
               tokens=PARITY_BATCH * PARITY_SEQ, moments=rc.moments_dtype,
               grad_compression=rc.grad_compression, loss_one_card=loss_one,
               loss_mesh=loss_mesh, loss_rel_err=loss_err, worst_leaf=worst,
               worst_rel_l2=errs[worst], loss_tol=PARITY_LOSS_TOL, param_tol=param_tol,
               leaves=len(errs), leaves_equal=sorted(got) == sorted(want))
    _train_emit(torch, rec, smi)
    if loss_err > PARITY_LOSS_TOL or errs[worst] > param_tol or sorted(got) != sorted(want):
        raise AssertionError(f"{phase}: the mesh and the one-card Trainer disagree: {rec}")


def train_mesh_parity(torch, smi: str) -> None:
    """qwen3-0.6b at full width cut to ``PARITY_LAYERS`` layers: f32 moments,
    then int8 moments with ``int8_ef``."""
    from repro_torch.configs.base import RunConfig, get_config

    cfg = get_config(ARCH).replace(num_layers=PARITY_LAYERS)
    kw = dict(dtype="float32", param_dtype="float32", remat="none", lr=TRAIN_LR,
              warmup_steps=5, total_steps=60)
    _mesh_parity(torch, "train_mesh_parity", cfg, RunConfig(**kw), PARITY_PARAM_TOL, smi)
    _mesh_parity(torch, "train_mesh_parity_int8_ef", cfg,
                 RunConfig(**kw, moments_dtype="int8", grad_compression="int8_ef"),
                 MESH_EF_PARAM_TOL, smi)


def _step_parts(ranks: list) -> dict:
    """One step of every rank: its collectives by label (calls, operand
    bytes, ring bytes received and seconds), summed over the ranks and rank
    0's; each rank's seconds in the step's parts (views, forward and
    backward, gradient reduction, optimizer) and inside collectives."""
    wire: dict = {}
    for r in ranks:
        for label, m in r["meter"].items():
            acc = wire.setdefault(label, {"calls": 0, "bytes": 0, "wire_bytes": 0,
                                          "seconds": 0.0})
            for k in acc:
                acc[k] += m[k]
    return {"wire_step": {"all_ranks": wire, "rank0": ranks[0]["meter"]},
            "step_laps_by_rank": [r["laps"] for r in ranks],
            "step_collective_s_by_rank": [r["seconds"][1] for r in ranks]}


def train_mesh(torch, smi: str):
    """qwen3-0.6b at full width cut to ``MESH_TRAIN_LAYERS`` layers, bf16,
    remat ``block``, on the mesh for ``MESH_TRAIN_STEPS`` steps of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens with a checkpoint at the end. Gates: loss and grad norm finite,
    the last 3 steps' mean loss below the first 3's, every rank within its
    share. Prints the step p50, each rank's state bytes beside the one-card
    state's, and a step's bytes on the wire by collective. Returns (cfg,
    the gathered parameters on the card)."""
    import math
    import shutil

    from repro_torch.configs.base import RunConfig, ShapeConfig, get_config
    from repro_torch.data import make_batches
    from repro_torch.kernels import ops
    from repro_torch.models import abstract_params
    from repro_torch.tree import leaves_with_paths, unflatten_like

    rec = _phase_start(torch, "train_mesh")
    cfg = get_config(ARCH).replace(num_layers=MESH_TRAIN_LAYERS)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat="block", lr=TRAIN_LR,
                   warmup_steps=3, total_steps=TRAIN_STEPS)
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    ops.reset_counts()
    t0 = time.perf_counter()
    mt = _mesh_trainer(torch, cfg, rc, ckpt_dir=MESH_CKPT, ckpt_every=MESH_TRAIN_STEPS)
    setup_s = time.perf_counter() - t0
    it = make_batches(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=0)
    t1 = time.perf_counter()
    mt.run(it, MESH_TRAIN_STEPS)
    run_s = time.perf_counter() - t1
    it.close()
    launched = {k: c for k, c in ops.kernel_counts().items() if c["launches"]}
    hist = mt.history
    bad = [h["step"] for h in hist if not (math.isfinite(h["loss"])
                                           and math.isfinite(h["grad_norm"]))]
    first = statistics.mean(h["loss"] for h in hist[:3])
    last = statistics.mean(h["loss"] for h in hist[-3:])
    rec.update(_history_record(mt, cfg, TRAIN_SEQ, TRAIN_BATCH), setup_s=setup_s, run_s=run_s,
               reduced={"num_layers": [get_config(ARCH).num_layers, MESH_TRAIN_LAYERS]},
               loss_first3=first, loss_last3=last, **_step_parts(mt.rank_steps[-1]),
               kernel_launches=len(launched),
               checkpoint_bytes=sum(os.path.getsize(os.path.join(dp, f))
                                    for dp, _, fs in os.walk(MESH_CKPT) for f in fs))
    _mesh_rec(torch, rec, mt)
    abstract = abstract_params(cfg, rc)
    full = mt.gather_state("params")
    gathered = unflatten_like(abstract, [full["params/" + n].to(DEVICE)
                                         for n, _ in leaves_with_paths(abstract)])
    mt.close()
    del full
    _train_emit(torch, rec, smi)
    if bad or not last < first or launched:
        raise AssertionError(f"train_mesh: loss not finite at {bad}, or not falling "
                             f"({first} -> {last}), or kernels launched ({launched})")
    return cfg, gathered


def train_mesh_moe(torch, smi: str) -> None:
    """deepseek-v2-lite at full width cut to ``MESH_MOE_LAYERS`` layers (its
    64 experts over ``model``), drawn on the card: ``MESH_MOE_STEPS`` bf16
    steps of ``MESH_MOE_BATCH`` x ``TRAIN_SEQ`` tokens (loss and grad norm
    finite), then the f32 parity at ``PARITY_LAYERS`` layers."""
    import math

    from repro_torch.configs.base import RunConfig, ShapeConfig, get_config
    from repro_torch.data import make_batches
    from repro_torch.models import init

    rec = _phase_start(torch, "train_mesh_moe")
    base = get_config(MOE_ARCH)
    cfg = base.replace(num_layers=MESH_MOE_LAYERS)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat="block", lr=TRAIN_LR,
                   warmup_steps=3, total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    mt = _mesh_trainer(torch, cfg, rc, init_generator="cuda")
    setup_s = time.perf_counter() - t0
    it = make_batches(cfg, ShapeConfig("train", TRAIN_SEQ, MESH_MOE_BATCH, "train"), seed=0)
    mt.run(it, MESH_MOE_STEPS)
    it.close()
    hist = mt.history
    bad = [h["step"] for h in hist if not (math.isfinite(h["loss"])
                                           and math.isfinite(h["grad_norm"]))]
    rec.update(_history_record(mt, cfg, TRAIN_SEQ, MESH_MOE_BATCH), setup_s=setup_s,
               reduced={"num_layers": [base.num_layers, MESH_MOE_LAYERS]},
               experts=cfg.num_experts, **_step_parts(mt.rank_steps[-1]))
    _mesh_rec(torch, rec, mt)
    mt.close()
    del mt
    _train_emit(torch, rec, smi)
    if bad:
        raise AssertionError(f"train_mesh_moe: loss or grad norm not finite at steps {bad}")
    pcfg = base.replace(num_layers=PARITY_LAYERS)
    prc = RunConfig(dtype="float32", param_dtype="float32", remat="none", lr=TRAIN_LR,
                    warmup_steps=5, total_steps=60)
    # the weights are passed, not held here: the one-card Trainer's go
    # before the mesh's are drawn
    _mesh_parity(torch, "train_mesh_moe_parity", pcfg, prc, PARITY_PARAM_TOL, smi,
                 params=init(pcfg, prc, torch.Generator(device=DEVICE).manual_seed(0),
                             device=DEVICE), generator="cuda")


# falcon-mamba-7b and hymba-1.5b at full width on the mesh: the Mamba mixer
# cut over inner (in_proj's paired cut), the hybrid block with attention
# whole on every rank (25 / 5 heads and a vocab of 32,001 on model=2), and
# sequence parallelism (seq -> model)
MESH_SSM_LAYERS = 4            # falcon-mamba-7b: 64 -> 4
MESH_HYBRID_LAYERS = 8         # hymba-1.5b: 32 -> 8 (layer 0 global, 1-7 sliding-window)
MESH_ARCH_STEPS, MESH_ARCH_SEQ, MESH_ARCH_BATCH = 4, 256, 4
SEQ_PARALLEL = {"seq": "model"}


def train_mesh_arch(torch, smi: str, phase: str, arch: str, layers: int,
                    overrides: dict) -> None:
    """``arch`` at full width cut to ``layers`` layers on the mesh, drawn on
    the card, under the rules ``overrides``: ``MESH_ARCH_STEPS`` bf16 steps
    of ``MESH_ARCH_BATCH`` x ``MESH_ARCH_SEQ`` tokens, remat ``block``.
    Gates: loss and grad norm finite, the last 2 steps' mean loss below the
    first 2's, no kernel launched, every rank within its share. Prints the
    step p50, each rank's state bytes and a step's collectives by label.
    Then ``<phase>_parity``: the f32 parity at ``PARITY_LAYERS`` layers."""
    import math

    from repro_torch.configs.base import RunConfig, ShapeConfig, get_config
    from repro_torch.data import make_batches
    from repro_torch.kernels import ops
    from repro_torch.models import init

    rec = _phase_start(torch, phase)
    base = get_config(arch)
    cfg = base.replace(num_layers=layers)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat="block", lr=TRAIN_LR,
                   warmup_steps=3, total_steps=TRAIN_STEPS, sharding_overrides=overrides)
    ops.reset_counts()
    t0 = time.perf_counter()
    mt = _mesh_trainer(torch, cfg, rc, init_generator="cuda")
    setup_s = time.perf_counter() - t0
    it = make_batches(cfg, ShapeConfig("train", MESH_ARCH_SEQ, MESH_ARCH_BATCH, "train"), seed=0)
    mt.run(it, MESH_ARCH_STEPS)
    it.close()
    launched = {k: c for k, c in ops.kernel_counts().items() if c["launches"]}
    hist = mt.history
    bad = [h["step"] for h in hist if not (math.isfinite(h["loss"])
                                           and math.isfinite(h["grad_norm"]))]
    first = statistics.mean(h["loss"] for h in hist[:2])
    last = statistics.mean(h["loss"] for h in hist[-2:])
    rec.update(_history_record(mt, cfg, MESH_ARCH_SEQ, MESH_ARCH_BATCH), setup_s=setup_s,
               reduced={"num_layers": [base.num_layers, layers]},
               sequence_parallel=bool(overrides), cut_over_model=sorted(mt.engine.cuts),
               loss_first2=first, loss_last2=last, kernel_launches=len(launched),
               **_step_parts(mt.rank_steps[-1]))
    _mesh_rec(torch, rec, mt)
    mt.close()
    del mt
    _train_emit(torch, rec, smi)
    if bad or not last < first or launched:
        raise AssertionError(f"{phase}: loss not finite at {bad}, or not falling "
                             f"({first} -> {last}), or kernels launched ({launched})")
    pcfg = base.replace(num_layers=PARITY_LAYERS)
    prc = RunConfig(dtype="float32", param_dtype="float32", remat="none", lr=TRAIN_LR,
                    warmup_steps=5, total_steps=60, sharding_overrides=overrides)
    _mesh_parity(torch, phase + "_parity", pcfg, prc, PARITY_PARAM_TOL, smi,
                 params=init(pcfg, prc, torch.Generator(device=DEVICE).manual_seed(0),
                             device=DEVICE), generator="cuda")


def train_mesh_ssm(torch, smi: str) -> None:
    """falcon-mamba-7b (d_model 4096, d_inner 8192, vocab 65,024) cut to
    ``MESH_SSM_LAYERS`` layers: its mixer cut over ``inner``."""
    train_mesh_arch(torch, smi, "train_mesh_ssm", SSM_ARCH, MESH_SSM_LAYERS, {})


def train_mesh_hybrid_sp(torch, smi: str) -> None:
    """hymba-1.5b (25 / 5 heads, vocab 32,001) cut to ``MESH_HYBRID_LAYERS``
    layers under sequence parallelism: attention and the vocab whole on
    every rank, the SSM branch and the MLP cut."""
    train_mesh_arch(torch, smi, "train_mesh_hybrid_sp", HYBRID_ARCH, MESH_HYBRID_LAYERS,
                    SEQ_PARALLEL)


def train_mesh_phases(torch, rc, smi: str) -> None:
    """The dp x tp training group, in order; ``rc`` is the serve phases'
    (``train_mesh_then_serve`` serves with it under ``ROBUST_POLICY``). The
    rank pool is stopped at the end."""
    import shutil

    from repro_torch.launch.mesh import close_rank_pool

    train_mesh_parity(torch, smi)
    cfg, gathered = train_mesh(torch, smi)
    train_then_serve(torch, cfg, rc, gathered, smi, phase="train_mesh_then_serve",
                     ckpt_dir=MESH_CKPT)
    del gathered
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    train_mesh_moe(torch, smi)
    train_mesh_ssm(torch, smi)
    train_mesh_hybrid_sp(torch, smi)
    close_rank_pool()
    free_device_memory(torch)


# the dry-run and roofline tooling's card path: the energy probe at full width
# under both policies of its docstring, and one production cell the rank
# programs accept, priced on meta tensors with the profile the card's name picks
PROBE_POLICIES = ("attn.*=int8,mlp.*=int2,*=bf16", "*=int4:prequant")
PROBE_BATCH, PROBE_SEQ = 4, 64
DRYRUN_CELL = ("deepseek-v2-lite-16b", "decode_32k")


def probe_energy(torch) -> dict:
    """``launch.probe.energy_probe`` on ``ARCH`` at full width (28 layers,
    d_model 1024, vocab 151,936; f32, the reference probe's RunConfig) under
    each of ``PROBE_POLICIES``: the surgered forward through ``tugemm_fused``
    and ``tugemm_stats`` (the counts are set to 0 before and read after),
    then the same probe through the plain versions on the card. Every
    GEMM's cycles must be identical, and the report's energy equal; only
    those two kernels may launch."""
    from repro_torch.kernels import ops
    from repro_torch.launch.probe import energy_probe

    out = {}
    for policy in PROBE_POLICIES:
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        rep = energy_probe(ARCH, policy=policy, batch=PROBE_BATCH, seq=PROBE_SEQ, device=DEVICE)
        wall = time.perf_counter() - t0
        counts = ops.kernel_counts()
        t1 = time.perf_counter()
        plain = energy_probe(ARCH, policy=policy, batch=PROBE_BATCH, seq=PROBE_SEQ,
                             device=DEVICE, impl="torch", label="energy (plain versions)")
        plain_wall = time.perf_counter() - t1
        rows = [(le.label, le.bits, le.serial_cycles, le.parallel_cycles) for le in rep.layers]
        want = [(le.label, le.bits, le.serial_cycles, le.parallel_cycles)
                for le in plain.layers]
        same = sum(a == b for a, b in zip(rows, want))
        rel = abs(rep.total_energy_j - plain.total_energy_j) / max(plain.total_energy_j, 1e-30)
        ran = {k: c for k, c in counts.items() if c["launches"] or c["plain_calls"]}
        rec = {"phase": "probe_energy", "arch": ARCH, "policy": policy, "batch": PROBE_BATCH,
               "seq": PROBE_SEQ, "gemms": len(rows), "cycles_equal": same,
               "total_cycles": rep.total_cycles, "plain_total_cycles": plain.total_cycles,
               "total_energy_j": rep.total_energy_j, "plain_total_energy_j":
               plain.total_energy_j, "energy_rel_diff": rel, "by_bits": {
                   b: {"cycles": v["cycles"], "energy_j": v["energy_j"]}
                   for b, v in rep.by_bits.items()},
               "wall_s": wall, "plain_wall_s": plain_wall, "kernel_counts": counts}
        emit(rec)
        if rows != want or rel > 1e-12:
            raise AssertionError(f"the energy probe's cycles on the kernels differ from the "
                                 f"plain versions': {same} of {len(rows)} GEMMs equal")
        if set(ran) != {"tugemm_fused", "tugemm_stats"} or any(
                c["plain_calls"] for c in ran.values()):
            raise AssertionError(f"the energy probe did not run only tugemm_fused and "
                                 f"tugemm_stats: {ran}")
        out[policy] = rec
    return out


def dryrun_cell(torch) -> dict:
    """One production cell (``DRYRUN_CELL`` on the 16×16 mesh) priced by
    ``launch.dryrun.run_cell`` on meta tensors with ``hw_profile("auto")``,
    which must pick ``h100`` by the card's name; prints its row (a price
    from counts, not a measurement)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.roofline.analysis import hw_profile

    hw = hw_profile("auto")
    t0 = time.perf_counter()
    arch, shape = DRYRUN_CELL
    row = run_cell(arch, SHAPES[shape], multi_pod=False, hw=hw)
    rec = {"phase": "dryrun_cell", "device_name": torch.cuda.get_device_name(),
           "profile": hw.name, "seconds": time.perf_counter() - t0, **row}
    emit(rec)
    if hw.name != "h100" or row["hw"] != "h100":
        raise AssertionError(f"hw_profile('auto') picked {hw.name!r} on "
                             f"{torch.cuda.get_device_name()!r}")
    if not (row["hlo_flops_per_chip"] > 0 and row["collective_bytes_per_chip"] > 0):
        raise AssertionError(f"the dry-run cell priced nothing: {row}")
    return rec


class PhaseClock:
    """Seconds each group of phases took, from the process start's build
    on; ``emit`` prints them on one line."""

    def __init__(self):
        self.t = self.t0 = time.perf_counter()
        self.laps: dict = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now

    def emit(self) -> None:
        emit({"phase": "phase_seconds", **self.laps,
              "total": time.perf_counter() - self.t0})


def expert_w_bytes(params) -> int:
    """Bytes of expert weights one tick reads (every MoE layer's three expert
    GEMMs run every tick, whatever the tokens): a float stack twice (the
    per-column scale reduction in ``fused_scales``, then the kernel's
    quantize on load), a packed one once (planes and scales)."""
    total = 0
    for group in params["groups"]:
        for block in group.values():
            for w in block["ffn"].get("experts", {}).values():
                total += (nbytes(w["qkernel"], w["qscale"]) if isinstance(w, dict)
                          else 2 * nbytes(w))
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if hasattr(tree, "numel") else []


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    clock = PhaseClock()
    t0 = time.perf_counter()
    took = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": took,
          "sources": list(build.SOURCES)})

    clock.lap("build")
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=DEVICE)
    gemm = check_gemm(torch, flush)
    attn = check_attention(torch, flush)
    unf = check_unfused(torch, flush)
    st = check_stats(torch, flush)
    moe_gemm = check_moe_gemm(torch, flush)
    moe_int = check_expert_int_gemm(torch, flush)
    del flush
    clock.lap("kernel_checks")

    cfg, rc, params, init_s = model_setup(torch)
    emit({"phase": "init", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "seconds": init_s})
    step_parity(torch, cfg, rc, params)

    sched, done, wall, counts, prompts = serve(torch, cfg, rc, params, "auto")
    outs = check_served(cfg, sched, done, prompts, {8, 2})
    # every fused GEMM collects stats (track_energy): tugemm_stats assembles them
    fused_kernels = ("tugemm_fused", "flash_paged_decode", "tugemm_stats")
    for name, c in counts.items():
        ran = c["launches"] > 0 if name in fused_kernels else c["launches"] == 0
        if not ran or c["plain_calls"] != 0:
            raise AssertionError(f"serve path did not run only the kernel of {name}: {counts}")
    gen = sum(len(o) for o in outs.values())
    emit(serve_record("serve", sched, done, wall, counts, prompts))

    # the same serve through the plain versions: how far greedy tokens agree
    # when the only difference is attention's f32 summation order
    _, done_p, wall_p, counts_p, _ = serve(torch, cfg, rc, params, "torch")
    outs_p = {r.rid: list(r.out) for r in done_p}
    same = sum(a == b for r in outs for a, b in zip(outs[r], outs_p[r]))
    emit({"phase": "serve_plain", "wall_s": wall_p, "tokens_per_s": gen / wall_p,
          "tokens_equal": same, "tokens": gen, "kernel_counts": counts_p})
    # the same requests on the dense KV layout (attention off the paged kernel)
    sched_d, counts_d = serve_dense(torch, cfg, rc, params, outs)
    dense_serves = {"serve_dense": (sched_d, counts_d)}
    del sched_d

    # the serving robustness and observability layer on the same model
    # (serve_traced runs after device_time: one profiler session over a
    # whole serve leaves torch.profiler without device events for the rest
    # of the process)
    base_pt, want_pt, rid0_done = serve_chaos(torch, cfg, rc, params)
    serve_fallback(torch, cfg, rc, params, want_pt, rid0_done)
    serve_overload(torch, cfg, rc, params)

    # prefix caching and speculative decoding on the same model
    slice_serves = {}
    want_sp, want_sp_kv = spec_reference(torch, cfg, rc, params)
    for phase, draft in (("serve_spec", "*=int2"), ("serve_spec_selfdraft", ROBUST_POLICY),
                         ("serve_spec_prequant", "*=int2:prequant")):
        slice_serves[phase] = serve_spec(torch, cfg, rc, params, want_sp, want_sp_kv, phase,
                                         draft)
    want_prefix = serve_prefix(torch, cfg, rc, params)
    sched_ps, counts_ps, cow = serve_prefix_spec(torch, cfg, rc, params, want_prefix)
    slice_serves["serve_prefix_spec"] = (sched_ps, counts_ps)
    del sched_ps

    # the compiled steps: each leg's requests through the eager step, then
    # through the CUDA graphs (the packed leg after the surgery below, the
    # deepseek-v2-lite leg in the mesh group, on its 4-layer model)
    serve_graphs(torch, "qwen3_fused", cfg, rc, params, {8, 2})
    serve_graphs(torch, "qwen3_spec", cfg, dataclasses.replace(
        rc, quant_policy=ROBUST_POLICY, spec_gamma=SPEC_GAMMA, draft_policy="*=int2"),
        params, {8, 2})

    # the same requests on offline-packed weights: fused, then unfused
    rc_pq, params_pq = surgered(cfg, rc, params, PREQUANT_POLICY)
    sched_pq, done_pq, wall_pq, counts_pq, _ = serve(torch, cfg, rc_pq, params_pq, "auto")
    outs_pq = check_served(cfg, sched_pq, done_pq, prompts, {8, 2})
    emit(serve_record("serve_prequant", sched_pq, done_pq, wall_pq, counts_pq, prompts))
    ran = {k for k, c in counts_pq.items() if c["launches"] > 0}
    if ran != set(fused_kernels) or any(
            c["plain_calls"] for c in counts_pq.values()):
        raise AssertionError(f"prequant serve did not run only the fused kernels: {counts_pq}")
    serve_graphs(torch, "qwen3_packed", cfg, rc_pq, params_pq, {8, 2})
    del params_pq

    rc_unf, params_unf = surgered(cfg, rc, params, UNFUSED_POLICY)
    step_parity(torch, cfg, rc_unf, params_unf, "step_parity_unfused")
    sched_unf, done_unf, wall_unf, counts_unf, _ = serve(torch, cfg, rc_unf, params_unf, "auto")
    # the unfused prequant MLPs record no cycles (the reference's behaviour)
    outs_unf = check_served(cfg, sched_unf, done_unf, prompts, {8})
    emit(serve_record("serve_unfused", sched_unf, done_unf, wall_unf, counts_unf, prompts))
    # the int8 GEMMs' stats come out of their own launches and tugemm_stats:
    # no absmax kernel runs
    unfused_kernels = ("tugemm_int8", "tugemm_packed", "tugemm_stats")
    for name in (*unfused_kernels, "flash_paged_decode"):
        c = counts_unf[name]
        if c["launches"] <= 0 or c["plain_calls"] != 0:
            raise AssertionError(f"unfused serve did not run only the kernel of {name}: "
                                 f"{counts_unf}")
    for name in ("tugemm_fused", "colabsmax", "rowabsmax", "unary_step_stats"):
        if counts_unf[name] != {"launches": 0, "plain_calls": 0}:
            raise AssertionError(f"unfused serve ran {name}: {counts_unf}")
    same = sum(a == b for r in outs_pq for a, b in zip(outs_pq[r], outs_unf[r]))
    cyc8 = (sched_unf.cycles_by_bits[8], sched_pq.cycles_by_bits[8])
    emit({"phase": "unfused_vs_prequant", "tokens_equal": same, "tokens": gen,
          "int8_cycles_equal": cyc8[0] == cyc8[1]})
    if outs_unf != outs_pq or cyc8[0] != cyc8[1]:
        raise AssertionError("the unfused serve's greedy tokens or int8 cycles differ from "
                             "the fused-prequant serve's")
    del params_unf

    # the C1 validation path: its kernels against their plain versions, then
    # the conformance run (its launches are this path's counts) and the
    # quickstart at full width
    from repro_torch.kernels import ops

    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=DEVICE)
    c1 = check_c1(torch, flush, params)
    del flush
    torch.cuda.synchronize()
    ops.reset_counts()
    c1_tot = c1_validation(torch, params)
    torch.cuda.synchronize()
    counts_c1 = ops.kernel_counts()
    emit({"phase": "c1_totals", **c1_tot, "kernel_counts": counts_c1})
    for name in ("quantize_sym", "temporal_unary_gemm", "tugemm_int8", "tugemm_stats",
                 "tugemm_fused"):
        c = counts_c1[name]
        if c["launches"] <= 0 or c["plain_calls"] != 0:
            raise AssertionError(f"the C1 path did not run only the kernel of {name}: "
                                 f"{counts_c1}")
    run_quickstart(torch)
    del params

    # what the qwen3-0.6b phases leave on the card: later lines read only
    # the serves' ticks and counts, serve_traced the weights and cycles;
    # each owner's share is what its release returns (DEVICE_TIMED, every
    # checked case's operands, goes after device_time)
    sched_serve = sched
    sched = types.SimpleNamespace(params=sched.params, cycles_by_bits=sched.cycles_by_bits)
    free_device_memory(torch)
    before = torch.cuda.memory_allocated()
    del sched_serve, base_pt, sched_pq, sched_unf
    free_device_memory(torch)
    mid = torch.cuda.memory_allocated()
    for d in (slice_serves, dense_serves):
        for ph, (sc, c) in list(d.items()):
            d[ph] = (types.SimpleNamespace(ticks=sc.ticks), c)
    free_device_memory(torch)
    after = torch.cuda.memory_allocated()
    emit({"phase": "free_qwen3_phases",
          "freed_gb": {"serve schedulers (serve, chaos, prequant, unfused)": (before - mid) / 1e9,
                       "spec / prefix / dense serve records": (mid - after) / 1e9},
          "memory_allocated_before_gb": before / 1e9,
          "memory_allocated_after_gb": after / 1e9})

    clock.lap("qwen3-0.6b phases")
    moe_serves = serve_moe_phases(torch)
    clock.lap("deepseek-v2-lite phases")
    # the legacy Engine on the SSM and hybrid archs, after deepseek's weights went
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=DEVICE)
    ssm_gemm = check_ssm_gemm(torch, flush)
    del flush
    engine_serves = serve_engine_phases(torch)
    clock.lap("engine phases")
    # the last archs' model paths, each model freed before the next is drawn
    audio, audio_counts = encode_audio(torch)
    clock.lap("encode_audio")
    arch_serves = serve_vl(torch)
    clock.lap("serve_vl")
    arch_serves.update(serve_llama4(torch))
    clock.lap("serve_llama4")
    dense_gemm, dense_attn, cli_serves, calib = dense_arch_phases(torch)
    arch_serves.update(cli_serves)
    clock.lap("cli, dense archs, static scales")
    # the dp x tp mesh: its kernels at one rank's shapes, then qwen3-0.6b
    # cut to MESH_DENSE_LAYERS layers and deepseek-v2-lite cut to
    # MESH_MOE_LAYERS layers, each against its own one-card serve
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=DEVICE)
    mesh_rank = check_mesh_rank(torch, flush)
    del flush
    mesh_serves = serve_mesh_phases(torch, cfg, rc, smi)
    clock.lap("mesh")
    # dp x tp training on the same card: qwen3-0.6b (parity at 2 layers, full
    # depth, its checkpoint served on the kernels) and deepseek-v2-lite
    train_mesh_phases(torch, rc, smi)
    clock.lap("mesh training")
    probes = probe_energy(torch)
    clock.lap("probe_energy")
    dryrun_cell(torch)
    clock.lap("dryrun_cell")
    device_times(torch)
    free_device_memory(torch)
    before = torch.cuda.memory_allocated()
    DEVICE_TIMED.clear()
    free_device_memory(torch)
    emit({"phase": "free_device_timed",
          "freed_gb": (before - torch.cuda.memory_allocated()) / 1e9})
    clock.lap("device_time")
    # training on qwen3-0.6b after device_time (whose operands it frees) and
    # before serve_traced (whose profiler session slows the rest of a process)
    train_phases(torch, cfg, rc, smi)
    clock.lap("training")
    traced = serve_traced(torch, cfg, rc, sched.params, smi)
    clock.lap("serve_traced")
    for r in moe_gemm + moe_int:
        want = 1 if r["kernel"] == "tugemm_packed" else 3
        if r["device_launches"] is not None and r["device_launches"] != want:
            raise AssertionError(f"an expert GEMM call is not {want} device operations "
                                 f"(memset, GEMM, tugemm_stats; the packed GEMM alone): {r}")
    serves = {**moe_serves, **slice_serves, **dense_serves, **arch_serves}

    layer = {g[0]: g for g in LAYER_GEMMS}
    picked = [r for r in gemm if r["case"] == "serve" and r["w_mode"] == "quant"
              and not r["per_token"] and not r["bias"] and any((r["K"], r["N"], r["bits"]) == v[1:]
                                        for v in layer.values())]
    per_layer = []
    for name, K, N, bits in LAYER_GEMMS:
        per_layer.append(next(r for r in picked if (r["K"], r["N"], r["bits"]) == (K, N, bits)))
    dec = next(r for r in attn if r["case"] == "gqa_decode_int8")
    ver = next(r for r in attn if r["case"] == "gqa_verify_int8")
    kernels = [
        {"name": "tugemm_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/tugemm_fused.cu",
         "replaces": "src/repro/kernels/tugemm_fused.py:151",
         "launches": counts["tugemm_fused"]["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in gemm + ssm_gemm + dense_gemm),
         "ms": sum(r["ms"] for r in per_layer),
         "plain_ms": sum(r["plain_ms"] for r in per_layer),
         "bound_ms": sum(r["bound_ms"] for r in per_layer),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in per_layer)
         else "operations",
         "library_ms": sum(r["library_ms"] for r in per_layer),
         **device_entry(per_layer),
         "shape": "the 7 GEMMs of one qwen3-0.6b layer at M=64 under " + POLICY,
         "launches_by_path": {"serve": counts["tugemm_fused"]["launches"], **{
             ph: c["tugemm_fused"]["launches"] for ph, (_, c) in serves.items()}, **{
             ph: r["kernel_counts"]["tugemm_fused"]["launches"]
             for ph, r in engine_serves.items()},
             "encode_audio": audio_counts["tugemm_fused"]["launches"],
             **{f"probe_energy {pol}": r["kernel_counts"]["tugemm_fused"]["launches"]
                for pol, r in probes.items()}},
         "launches_per_tick_by_path": {ph: c["tugemm_fused"]["launches"] / sc.ticks
                                       for ph, (sc, c) in serves.items()},
         "serve_traced_launches": traced["tugemm_fused"],
         "experts": expert_entry(moe_gemm, moe_serves),
         "ssm": ssm_entry(ssm_gemm),
         "dense_archs": dense_entry(dense_gemm),
         "static_scale": {r["case"]: {k: r[k] for k in (
             "M", "K", "N", "bits", "clipped_share", "max_abs_err", "ms", "device_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library_device_ms")}
             for r in dense_gemm if r.get("static")},
         "calibrate_static_launches": calib["kernel_counts"]["tugemm_fused"]["launches"],
         "edge_deployment_launches":
             calib["edge"]["kernel_counts"]["tugemm_fused"]["launches"],
         **mesh_entry("tugemm_fused", mesh_rank, mesh_serves)},
        {"name": "flash_paged_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_paged.cu",
         "replaces": "src/repro/kernels/flash_paged.py:193",
         "launches": counts["flash_paged_decode"]["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in attn + dense_attn),
         "ms": dec["ms"], "device_ms": dec["device_ms"],
         "device_ms_source": dec["device_ms_source"], "plain_ms": dec["plain_ms"],
         "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
         "library_ms": dec["library_ms"], "library_device_ms": dec["library_device_ms"],
         "shape": "decode: B=4, 16 heads over 8 kv heads, hd 128, int8 pages of 16, "
                  f"kv_len {dec['kv_len']}",
         "launches_by_path": {"serve": counts["flash_paged_decode"]["launches"], **{
             ph: c["flash_paged_decode"]["launches"] for ph, (_, c) in serves.items()}, **{
             ph: r["kernel_counts"]["flash_paged_decode"]["launches"]
             for ph, r in engine_serves.items()}},
         "launches_per_tick_by_path": {ph: c["flash_paged_decode"]["launches"] / sc.ticks
                                       for ph, (sc, c) in {**slice_serves,
                                                          **arch_serves}.items()},
         "serve_traced_launches": traced["flash_paged_decode"],
         "verify": {k: ver[k] for k in (
             "sq", "kv_len", "splits", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "library_device_ms")},
         "mla_serve": {r["case"]: {k: r[k] for k in (
             "kv_len", "splits", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "library_device_ms")}
             for r in attn if r["case"].startswith("mla_serve_")},
         # rows that are not whole 16-byte pieces: the narrow path
         "narrow": {r["case"]: {k: r[k] for k in (
             "sq", "hd_tot", "kv_dtype", "kv_len", "splits", "max_abs_err", "ms", "device_ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms")}
             for r in attn if r["case"].startswith("smollm_smoke_")},
         **mesh_entry("flash_paged_decode", mesh_rank, mesh_serves),
         "dense_archs": {r["case"]: {k: r[k] for k in (
             "sq", "heads", "kv_heads", "hd_tot", "kv_len", "splits", "max_abs_err", "ms",
             "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms")}
             for r in dense_attn}},
    ]
    # the unfused path's kernels: one qwen3-0.6b layer's calls at M=64
    # (k and v share a shape, as gate and up do)
    per_layer = {
        "tugemm_int8": ("attn.q", "attn.k/v", "attn.k/v", "attn.o"),
        "tugemm_packed": ("mlp.gate/up", "mlp.gate/up", "mlp.down"),
        "colabsmax": ("attn.q", "attn.k/v", "attn.k/v", "attn.o"),
        "rowabsmax": ("attn.q", "attn.k/v", "attn.k/v", "attn.o"),
    }
    replaces = {"tugemm_int8": "src/repro/kernels/tugemm_int8.py:57",
                "tugemm_packed": "src/repro/kernels/tugemm_packed.py:47",
                "colabsmax": "src/repro/kernels/unary_stats.py:37",
                "rowabsmax": "src/repro/kernels/unary_stats.py:66"}
    for name, cases in per_layer.items():
        rows = [next(r for r in unf if r["kernel"] == name and r["case"] == c
                     and r.get("M", 64) == 64 and not r.get("stats")) for c in cases]
        libs = [r["library_ms"] for r in rows]
        absmax = "absmax" in name
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/" + ("unary_stats.cu" if absmax else f"{name}.cu"),
            "replaces": replaces[name], "launches": counts_unf[name]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in unf if r["kernel"] == name),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": None if None in libs else sum(libs),
            **device_entry(rows),
            "shape": (f"absmax_kernel on one operand, one qwen3-0.6b layer's {len(rows)} "
                      "attention operands (M=64); the unfused serve takes these maxima from "
                      "its int8 GEMMs' tiles (the tugemm_stats entry) and launches this "
                      "kernel no time") if absmax else
            f"one qwen3-0.6b layer's {len(rows)} calls at M=64 under " + UNFUSED_POLICY,
            **({} if absmax else {
                "launches_by_path": {"serve_unfused": counts_unf[name]["launches"], **{
                    ph: c[name]["launches"] for ph, (_, c) in moe_serves.items()}},
                "experts": expert_int_entry(moe_int, name),
                **(mesh_entry(name, mesh_rank, mesh_serves) if name == "tugemm_int8"
                   else {})})})
    # rows 5-6 as the unfused serve runs them: each int8 GEMM takes both
    # maxima from its own tiles (memset + the stats instantiation) and
    # tugemm_stats assembles them. Its work: the GEMM with stats over the
    # GEMM without (call and device time); its plain version and bound:
    # the stats of the same operands (unary_step_stats, reading A and B once)
    pair = [next(r for r in st if r["kernel"] == "unary_step_stats" and r["case"] == c
                 and r["M"] == 64) for c in per_layer["colabsmax"]]
    route = [next(r for r in st if r["kernel"] == "stats_route" and r["case"] == "int8 " + c
                  and r["M"] == 64) for c in per_layer["colabsmax"]]
    gemm8 = [next(r for r in unf if r["kernel"] == "tugemm_int8" and r["case"] == c
                  and r["M"] == 64 and not r.get("stats")) for c in per_layer["colabsmax"]]
    dev = sum(r["device_ms"] - r["no_stats_device_ms"] for r in route)
    bound = sum(r["bound_ms"] for r in pair)
    kernels.append({
        "name": "tugemm_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/unary_stats.cu",
        "replaces": replaces["colabsmax"], "replaces_also": replaces["rowabsmax"],
        "launches": counts_unf["tugemm_stats"]["launches"],
        "launches_by_path": {"serve": counts["tugemm_stats"]["launches"],
                             "serve_prequant": counts_pq["tugemm_stats"]["launches"],
                             "serve_unfused": counts_unf["tugemm_stats"]["launches"],
                             **{ph: c["tugemm_stats"]["launches"]
                                for ph, (_, c) in serves.items()},
                             **{ph: r["kernel_counts"]["tugemm_stats"]["launches"]
                                for ph, r in engine_serves.items()},
                             "encode_audio": audio_counts["tugemm_stats"]["launches"],
                             **{f"probe_energy {pol}": r["kernel_counts"]["tugemm_stats"][
                                 "launches"] for pol, r in probes.items()}},
        "serve_traced_launches": traced["tugemm_stats"],
        "expert_launches_per_call": max(r["launches_a_call"]["tugemm_stats"] for r in moe_gemm
                                        if r["experts"] > 1),
        "max_abs_err": max(r["max_abs_err"] for r in st + [r for r in unf if r.get("stats")]),
        "ms": sum(r["ms"] for r in route) - sum(r["ms"] for r in gemm8),
        "plain_ms": sum(r["plain_ms"] for r in pair), "bound_ms": bound,
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in pair) else "operations",
        "library_ms": None, "device_ms": dev, "device_ms_source": route[0]["device_ms_source"],
        "library_device_ms": None, "bound_share": bound / dev,
        **mesh_entry("tugemm_stats", [], mesh_serves),
        "route_device_launches_per_call": None if any(r["device_launches"] is None
                                                      for r in route)
        else max(r["device_launches"] for r in route),
        "shape": "the stats of one qwen3-0.6b layer's 4 attention int8 GEMMs (M=64) under "
                 + UNFUSED_POLICY + ": ops.matmul_int8 with stats less the GEMM without "
                 "(memset, the maxima in the GEMM's tiles, the tugemm_stats launch); plain "
                 "and bound: the stats from A and B; launches: the unfused serve's, one a "
                 "GEMM; no single PyTorch call computes them (library_ms null)"})
    # the C1 path's kernels: one qwen3-0.6b layer's operand quantizations (7
    # weights per column, 7 activations per tensor, bf16, at the serve policy's
    # bits) and its 7 temporal GEMMs at M=64
    bits_of = {n: bits for n, _, _, bits in LAYER_GEMMS}
    q_rows = [r for r in c1 if r["kernel"] == "quantize_sym" and r["serve"]]
    t_rows = [next(r for r in c1 if r["case"] == f"{n} serve") for n, *_ in LAYER_GEMMS]
    q_launches = [r["device_launches"] for r in q_rows]   # None from CUDA events
    if any(n is not None and n != 1 for n in q_launches):
        raise AssertionError(f"ops.quantize_sym is not one device operation a call: "
                             f"{q_launches}")
    for name, rows, src, rep, lib, shape in (
            ("quantize_sym", q_rows, "quantize_sym.cu", "src/repro/kernels/quantize.py:28", None,
             "one qwen3-0.6b layer's 14 operand quantizations through ops.quantize_sym as "
             "c1_operands calls it (7 weights per column, (N,) scale; 7 activations (64, K) "
             "per tensor, 0-d scale), bf16, at the bits of " + POLICY + "; bound: x, q and "
             "the scale as given (4N bytes per column, 4 per tensor); no single PyTorch call "
             "computes it (library_ms null)"),
            ("temporal_unary_gemm", t_rows, "temporal_unary.cu",
             "src/repro/kernels/temporal_unary.py:54",
             sum(r["library_ms"] for r in t_rows),
             "one qwen3-0.6b layer's 7 GEMMs at M=64 decomposed into 2^(w-1) unary steps at "
             "the bits of " + POLICY + "; library: torch._int_mm of the undecomposed product")):
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/" + src,
            "replaces": rep, "launches": counts_c1[name]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in c1 if r["kernel"] == name),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": lib, **device_entry(rows), "shape": shape})
    clock.emit()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
