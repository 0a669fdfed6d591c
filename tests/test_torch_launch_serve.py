"""Port parity for the serving CLI: ``repro_torch.launch.serve.main`` against
``repro.launch.serve.main`` on the CPU with the same argv, the reference's
seeded weights handed to the port through ``main``'s ``params`` seam
(carried across by ``interop.params_from_reference``). Both launchers draw
the same prompts from ``np.random.default_rng(seed)``.

Per case the finished requests' token streams are identical, and so are the
summary lines with their wall-clock figures taken out (request and token
counts, cache stats, health counters, prefix-cache and speculation counts,
per-request energy, the number of latency samples). The cases: a paged int8
KV pool under the mixed policy (with ``--trace`` and ``--metrics-out``,
whose files must validate), ``--prefix-cache``, ``--spec-gamma 2``, and
``falcon-mamba-7b_smoke``, which falls back to the legacy Engine and the
dense layout with the reference's messages. On a CPU mesh of gloo ranks
(``--mesh``, ``--devices``) the CLI serves the single-device CLI's tokens
and summary, plus its ``mesh:`` line and, as the reference prints it on a
mesh, the ``sharding:`` line of its (1, 1) context's dropped rules;
``--data`` / ``--model`` above 1 serve on the rank pool at (data, model),
as ``--mesh`` does.

The reference launcher wraps its serve in a 1×1 ``jax.make_mesh``, whose
axes this JAX makes ``Explicit`` by default, and ``with_sharding_constraint``
then refuses the model's constraints (the breakage behind ROADMAP C4's
reference failures). The test hands the reference launcher the same 1×1
mesh with ``Auto`` axes, which is what its sharding code was written for;
nothing else of the reference is touched."""

import json
import re

import jax
import numpy as np
import pytest

from repro.configs.base import RunConfig, get_config
from repro.launch import serve as j_serve
from repro.models import init as j_init
from repro.obs.trace import validate_chrome_trace
from repro_torch.interop import params_from_reference
from repro_torch.launch import serve as t_serve
from repro_torch.launch.mesh import close_rank_pool

BASE = ["--requests", "3", "--prompt-len", "6", "--max-new", "4", "--max-batch", "2",
        "--capacity", "32", "--block-size", "4", "--prefill-chunk", "5", "--seed", "3"]
PAGED = ["--kv-layout", "paged", "--kv-dtype", "int8", "--policy",
         "attn.*=int8,mlp.*=int2,*=bf16", "--energy"]
CASES = {
    "paged_int8_mixed": ["--arch", "qwen3-0.6b_smoke", *PAGED],
    "prefix_cache": ["--arch", "qwen3-0.6b_smoke", *PAGED, "--prefix-cache"],
    "spec": ["--arch", "qwen3-0.6b_smoke", *PAGED, "--spec-gamma", "2"],
    "legacy_fallback": ["--arch", "falcon-mamba-7b_smoke", "--kv-layout", "paged",
                        "--gemm-backend", "int8", "--spec-gamma", "2"],
}
_TIMED = re.compile(r" in [0-9.]+s \([0-9.]+ tok/s\)")


@pytest.fixture(autouse=True)
def _auto_axes_mesh(monkeypatch):
    def make_local_mesh(data: int = 1, model: int = 1):
        return jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    monkeypatch.setattr(j_serve, "make_local_mesh", make_local_mesh)


def _summary(out: str) -> list[str]:
    """The launcher's lines without wall-clock figures: the first line's
    seconds and tokens/s go, the latency line keeps its sample counts, a
    file path is replaced by its kind."""
    lines = []
    for line in out.splitlines():
        if line.startswith("  latency:"):
            line = "latency " + " ".join(re.findall(r"\(n=\d+\)", line))
        elif line.startswith("  trace:"):
            line = re.sub(r"trace: \S+", "trace: <path>", line)
        elif line.startswith("  metrics:"):
            line = "metrics appended"
        lines.append(_TIMED.sub("", line))
    return lines


def _reference_params(argv):
    """The reference launcher's weights: ``init`` under its CPU RunConfig
    (f32) from ``PRNGKey(seed)``, as numpy."""
    arch = argv[argv.index("--arch") + 1]
    seed = int(argv[argv.index("--seed") + 1])
    rc = RunConfig(dtype="float32", param_dtype="float32", remat="none")
    params = j_init(get_config(arch), rc, jax.random.PRNGKey(seed))
    return params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_reference(case, capsys, tmp_path):
    argv = BASE + CASES[case]
    extra = {}
    if case == "paged_int8_mixed":
        extra = {side: ["--trace", str(tmp_path / f"{side}.json"),
                        "--metrics-out", str(tmp_path / f"{side}.jsonl")]
                 for side in ("ref", "port")}
    ref = j_serve.main(argv + extra.get("ref", []))
    ref_out = capsys.readouterr().out
    port = t_serve.main(argv + extra.get("port", []) + ["--device", "cpu"],
                        params=_reference_params(argv))
    port_out = capsys.readouterr().out

    assert {r.rid: r.out for r in port} == {r.rid: r.out for r in ref}
    assert len(port) == 3 and all(len(r.out) == 4 for r in port)
    assert _summary(port_out) == _summary(ref_out)
    if case == "legacy_fallback":
        assert "falling back to the legacy engine" in port_out
        assert "legacy engine: forcing --kv-layout dense" in port_out
        assert "legacy engine cannot speculate" in port_out
    if case == "prefix_cache":
        assert "  prefix: hits=" in port_out
    if case == "spec":
        assert "  spec: gamma=2" in port_out
    if extra:
        obj = json.loads((tmp_path / "port.json").read_text())
        validate_chrome_trace(obj)
        assert any(e.get("name") == "tick" for e in obj["traceEvents"])
        rec = json.loads((tmp_path / "port.jsonl").read_text().splitlines()[-1])
        assert rec["arch"] == "qwen3-0.6b_smoke" and rec["engine"] == "scheduler"
        assert rec["metrics"].keys() == json.loads(
            (tmp_path / "ref.jsonl").read_text().splitlines()[-1])["metrics"].keys()


# the mesh flags' cases: a GQA arch at dp=4 x tp=2 (its 2 kv heads), and
# the MLA + MoE arch at dp=2 x tp=4 (4 heads, 4 experts)
MESH_CASES = {
    "--devices": ["--arch", "qwen3-0.6b_smoke", *PAGED, "--max-batch", "4", "--mesh", "4,2",
                  "--mesh-backend", "gloo"],
    "--mesh": ["--arch", "deepseek-v2-lite-16b_smoke", *PAGED, "--policy",
               "mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16", "--mesh", "2,4", "--mesh-backend",
               "gloo"],
}


@pytest.fixture
def _stop_rank_pool():
    yield
    close_rank_pool()


@pytest.mark.parametrize("flags", [["--devices", "8"], ["--mesh", "2,4"], ["--data", "2"],
                                   ["--model", "2"]])
def test_mesh_flags_raise(flags, capsys, _stop_rank_pool):
    """``--data`` / ``--model`` above 1 serve on the rank pool at (data,
    model): they need ``--mesh-backend``, a ``--mesh`` that says otherwise is
    refused, and ``--data 2`` gives the single-device CLI's tokens with the
    ``mesh:`` line of a dp=2 tp=1 pool. ``--devices 8`` and ``--mesh`` serve
    on a CPU mesh of gloo ranks: the tokens and the summary lines equal the
    single-device CLI's, and the summary adds the ``mesh:`` and
    ``sharding:`` lines; a mesh wanting more ranks than ``--devices`` gives
    is refused with the reference's message, and one without
    ``--mesh-backend`` is refused."""
    if flags[0] in ("--data", "--model"):
        argv = ["--arch", "qwen3-0.6b_smoke", "--device", "cpu", *flags]
        with pytest.raises(SystemExit):
            t_serve.main(argv)
        assert "--mesh needs --mesh-backend" in capsys.readouterr().err
        with pytest.raises(SystemExit, match="ask for different meshes"):
            t_serve.main(argv + ["--mesh", "2,4", "--mesh-backend", "gloo"])
        if flags[0] == "--data":
            single = BASE + ["--max-batch", "4", "--arch", "qwen3-0.6b_smoke", *PAGED]
            params = _reference_params(single)
            one = t_serve.main(single + ["--device", "cpu"], params=params)
            capsys.readouterr()
            mesh = t_serve.main(single + ["--device", "cpu", *flags, "--mesh-backend", "gloo"],
                                params=params)
            out = capsys.readouterr().out
            assert {r.rid: r.out for r in mesh} == {r.rid: r.out for r in one}
            assert "  mesh: dp=2 tp=1 devices=2 " in out
        return
    base = BASE + ["--max-batch", "4"] + MESH_CASES[flags[0]]
    mesh_at = base.index("--mesh")
    single = base[:mesh_at] + base[mesh_at + 4:]
    extra = flags if flags[0] == "--devices" else []
    params = _reference_params(single)
    one = t_serve.main(single + ["--device", "cpu"], params=params)
    one_out = capsys.readouterr().out
    mesh = t_serve.main(base + extra + ["--device", "cpu"], params=params)
    mesh_out = capsys.readouterr().out
    assert {r.rid: r.out for r in mesh} == {r.rid: r.out for r in one}
    lines = _summary(mesh_out)
    mesh_line = [ln for ln in lines if ln.startswith("  mesh:")]
    assert len(mesh_line) == 1
    dp, tp = base[mesh_at + 1].split(",")
    assert f"mesh: dp={dp} tp={tp} devices=8 " in mesh_line[0]
    assert "backend=gloo" in mesh_line[0] and "wire_bytes=" in mesh_line[0]
    assert [ln for ln in lines if not ln.startswith(("  mesh:", "  sharding:"))] == \
        _summary(one_out)
    assert "  sharding: replicated_dims=0 dropped_rules={'batch': ('pod', 'data'), " in mesh_out
    if flags[0] == "--mesh":
        # no backend is chosen for the caller
        with pytest.raises(SystemExit):
            t_serve.main(single + ["--mesh", "2,4", "--device", "cpu"], params=params)
        assert "--mesh needs --mesh-backend" in capsys.readouterr().err
    if flags[0] == "--devices":
        with pytest.raises(ValueError, match="wants 8 devices, only 4 available"):
            t_serve.main(base + ["--devices", "4", "--device", "cpu"], params=params)


def test_card_is_the_default_device(monkeypatch):
    """Without ``--device cpu`` the launcher asks for the card and raises
    where there is none, before any weight is drawn."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.main(["--arch", "qwen3-0.6b_smoke"])
