"""The port's six examples (``repro_torch.examples``), on the CPU.

Part 1 imports no JAX and nothing of ``repro``: each example runs with
``--device cpu`` at its reference size (``train_lm`` at fewer steps) and
its returned record is checked; without ``--device cpu`` and with no card
each one raises; no module of the port, and not ``chip_smoke.py``,
imports ``jax`` or ``repro``.

Part 2 holds the examples against the reference scripts
(``examples/*.py``, run in process on the CPU): quickstart and
optimize_gemm, given the reference's specs under the TPU tile, give its
transfer totals and pattern classes bit for bit; serve_lm on the
reference's parameters (``params_from_reference``) gives each greedy
request the tokens of the reference's model decoding it alone; train_lm
on them follows its loss curve within ``LOSS_RTOL``.
"""

import copy
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import (
    heatmap_gallery, optimize_gemm, quickstart, serve_lm, serve_long_context, train_lm,
)
from repro_torch.models.model import LM

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {"quickstart": quickstart, "optimize_gemm": optimize_gemm,
            "heatmap_gallery": heatmap_gallery, "serve_lm": serve_lm,
            "serve_long_context": serve_long_context, "train_lm": train_lm}
# relative tolerance of the port's training losses against the reference's
# over the first steps: float32 sums in another order, through AdamW
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- part 1: the port alone ---------------------------------------------------------------


def test_quickstart_profiles_fixes_and_launches(tmp_path):
    out = quickstart.main(["--device", "cpu", "--out", str(tmp_path / "qs")])
    assert out["transfers"]["v01"] <= out["transfers"]["v00"]
    assert out["transfers"] == {"v00": 168820736, "v01": 138543104}
    assert "false-sharing@C" in out["patterns"]["v00"]
    assert "false-sharing@C" not in out["patterns"]["v01"]
    assert out["speedup_estimate"] > 1 and out["max_abs_diff"] == 0.0
    assert Path(out["report"]).is_file() and (tmp_path / "qs" / "iter1").is_dir()


def test_optimize_gemm_ladder_falls_round_by_round():
    rounds = optimize_gemm.main(["--device", "cpu"])
    per_row = [rounds[r]["per_row"] for r in ("v00", "v01", "v02")]
    assert per_row[0] > per_row[1] > per_row[2]
    assert [rounds[r]["c_rows"] for r in ("v00", "v01", "v02")] == [1024, 32, 1024]
    for r in rounds.values():
        assert r["run"]["device"] == "cpu" and r["run"]["max_abs_err"] == 0.0


def test_heatmap_gallery_writes_one_entry_per_rung(tmp_path):
    from repro_torch import kernels as kreg

    out = heatmap_gallery.main(["--device", "cpu", "--out", str(tmp_path / "g")])
    want = {"baseline": [(n, kreg.get(n).variants[0].name) for n in kreg.names()],
            "optimized": [(n, kreg.get(n).variants[-1].name) for n in kreg.names()]}
    assert out["rungs"] == want
    for label, index in out["bundles"].items():
        assert Path(index).is_file()
        csvs = sorted(p.stem for p in Path(index).parent.glob("*.csv"))
        assert csvs == sorted(n for n, _ in want[label])
    assert (tmp_path / "g" / "gallery_diff.txt").read_text().strip() == out["summary"]
    # every rung with a kernel ran it (its plain version, here)
    assert {k for k, run in out["runs"].items() if run["device"] == "cpu"} == {
        f"{n}:{v}" for label in want for n, v in want[label]
        if kreg.get(n).variant(v).kernel is not None}


def test_serve_lm_finishes_every_request():
    out = serve_lm.main(["--device", "cpu"])
    reqs = out["requests"]
    assert [r.rid for r in reqs] == list(range(serve_lm.N_REQUESTS))
    assert all(r.done and len(r.out_tokens) == serve_lm.MAX_TOKENS for r in reqs)
    assert out["ticks"] > 0 and out["device"] == "cpu"


def test_serve_lm_request_that_sets_the_length_decodes_as_alone():
    """Every greedy request, request 0 (the longest prompt of the first
    wave) and the ones beside it or admitted into refilled slots, decodes
    as a batch-1 prefill and decode steps would."""
    out = serve_lm.main(["--device", "cpu"])
    model = out["model"]
    greedy = [r for r in out["requests"] if r.temperature == 0.0]
    assert [r.rid for r in greedy] == [0, 2, 4, 6, 8]
    for req in greedy:
        caches = model.init_caches(1, 128, dtype=torch.float32)
        with torch.no_grad():
            logits, caches = model.prefill(torch.from_numpy(req.prompt.astype(np.int64))[None],
                                           caches)
            toks = [int(logits[0, -1].argmax())]
            while len(toks) < serve_lm.MAX_TOKENS:
                logits, caches = model.decode_step(torch.tensor([[toks[-1]]]), caches)
                toks.append(int(logits[0, -1].argmax()))
        assert req.out_tokens == toks, req.rid


def test_serve_lm_serve_on_a_copy_of_the_model_gives_the_same_greedy_tokens():
    out = serve_lm.main(["--device", "cpu"])
    again, _, _ = serve_lm.serve(copy.deepcopy(out["model"]).to("cpu"), 0)
    assert [r.out_tokens for r in again if r.temperature == 0.0] == \
        [r.out_tokens for r in out["requests"] if r.temperature == 0.0]


def test_serve_long_context_ssm_state_is_flat():
    out = serve_long_context.main(["--device", "cpu"])
    rows = out["rows"]
    assert sorted(rows) == list(serve_long_context.PREFILLS)
    assert len({r["ssm_mb"] for r in rows.values()}) == 1
    assert all(r["ssm_mb"] < r["gqa_mb"] for r in rows.values())
    assert all(r["ssm_ms"] > 0 and r["gqa_ms"] > 0 for r in rows.values())


def test_serve_long_context_holds_both_caches_at_max_seq(capsys):
    """Both caches are allocated at ``max_seq`` before the prefill: the GQA
    cache holds 4 layers x K and V x 2048 positions x 4 heads x 16 x 4 B =
    4 MiB at every prefill, and the printed claim says so."""
    out = serve_long_context.main(["--device", "cpu"])
    assert out["max_seq"] == 2048
    assert {r["gqa_mb"] for r in out["rows"].values()} == {4.0}
    text = capsys.readouterr().out
    assert "allocated at max_seq = 2048" in text and "grows linearly" not in text


def test_train_lm_restart_equals_the_uninterrupted_run():
    """Steps 3-5 follow the restore in one run and run uninterrupted in
    the other: the same losses, bit for bit."""
    cut = train_lm.main(["--device", "cpu", "--steps", "7", "--restart-at", "3"])
    whole = train_lm.main(["--device", "cpu", "--steps", "7", "--restart-at", "6"])
    assert cut["restart_at"] == 3 and whole["restart_at"] == 6
    assert cut["losses"][:6] == whole["losses"][:6]
    assert cut["losses"][-1] < cut["losses"][0]


def test_train_lm_on_a_one_rank_mesh_matches_no_mesh():
    plain = train_lm.main(["--device", "cpu", "--steps", "4"])
    mesh = train_lm.main(["--device", "cpu", "--steps", "4", "--mesh", "1x1"])
    assert mesh["mesh"] == {"data": 1, "model": 1} and plain["mesh"] is None
    np.testing.assert_allclose(mesh["losses"], plain["losses"], rtol=1e-5)
    assert not torch.distributed.is_initialized()


def test_train_lm_takes_an_assigned_arch_s_smoke_config():
    out = train_lm.main(["--device", "cpu", "--arch", "granite-8b", "--smoke", "--steps", "2"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["checkpoints"] == [1]


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_without_a_card_each_example_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main(["--device", "cuda"])


# an import of jax or of repro (``repro\b`` does not match ``repro_torch``)
_FOREIGN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)\b", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_module_of_the_port_imports_jax_or_repro(path):
    assert not _FOREIGN.findall((ROOT / path).read_text()), path


# -- part 2: against the reference scripts -------------------------------------------------


def reference_example(name):
    """``examples/<name>.py`` of the JAX package, loaded as a module."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def classes(reports):
    return sorted(f"{r.pattern}@{r.region}" for r in reports)


def config_for_reference(cfg):
    """The reference's ``ModelConfig`` with the fields of a port one."""
    import dataclasses

    import jax.numpy as jnp

    from repro.models import ModelConfig as RefModelConfig

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[cfg.dtype]
    names = {f.name for f in dataclasses.fields(RefModelConfig)}
    return RefModelConfig(**{k: v for k, v in fields.items() if k in names})


def test_quickstart_under_the_tpu_tile_gives_the_reference_s_totals(tmp_path, monkeypatch):
    from repro.core.session import load_iteration
    from repro.kernels import gemm as ref_gemm
    from torch_parity import to_port_spec

    ref = reference_example("quickstart")
    monkeypatch.setattr(ref, "SESS", str(tmp_path / "ref"))
    ref.main()
    want = {v: load_iteration(tmp_path / "ref" / f"iter{i}").kernel("gemm")
            for i, v in enumerate(("v00", "v01"))}
    monkeypatch.setattr(quickstart, "gemm_v00_spec",
                        lambda m, n, k: to_port_spec(ref_gemm.gemm_v00_spec(m, n, k)))
    monkeypatch.setattr(quickstart, "gemm_v01_spec",
                        lambda m, n, k: to_port_spec(ref_gemm.gemm_v01_spec(m, n, k)))
    got = quickstart.main(["--device", "cpu", "--out", str(tmp_path / "port")])
    assert got["transfers"] == {v: pk.transactions for v, pk in want.items()}
    assert got["patterns"] == {v: classes(pk.reports) for v, pk in want.items()}


def test_optimize_gemm_under_the_tpu_tile_gives_the_reference_s_totals(monkeypatch):
    from repro.core import api as ref_api
    from repro.kernels import gemm as ref_gemm
    from torch_parity import to_port_spec

    ref = reference_example("optimize_gemm")
    maps, per_row = [], []
    heatmap, round_report = ref_api.heatmap, ref.round_report
    monkeypatch.setattr(ref_api, "heatmap", lambda *a: maps.append(heatmap(*a)) or maps[-1])
    monkeypatch.setattr(ref, "round_report",
                        lambda *a: per_row.append(round_report(*a)) or per_row[-1])
    ref.main()
    for name in ("gemm_v00_spec", "gemm_v01_spec", "gemm_v02_spec"):
        build = getattr(ref_gemm, name)
        monkeypatch.setattr(optimize_gemm, name,
                            lambda m, n, k, build=build: to_port_spec(build(m, n, k)))
    got = optimize_gemm.main(["--device", "cpu"])
    rungs = ("v00", "v01", "v02")
    assert [got[r]["transfers"] for r in rungs] == [hm.sector_transactions() for hm in maps]
    assert [got[r]["patterns"] for r in rungs] == [
        classes(ref_api.detect_all(hm)) for hm in maps]
    assert [got[r]["per_row"] for r in rungs] == per_row


def test_heatmap_gallery_under_the_tpu_tile_gives_the_reference_s_totals(tmp_path, monkeypatch):
    """The reference's specs under the TPU tile (``reference_rungs``) through
    the port's gallery: every rung's transfers and classes in both
    iterations, and the session diff's summary, are the reference
    gallery's."""
    import types

    from repro import kernels as rk
    from repro.core.session import load_iteration as ref_load_iteration
    from repro_torch import kernels as kreg
    from repro_torch.core.session import load_iteration
    from torch_parity import reference_rungs

    ref = reference_example("heatmap_gallery")
    monkeypatch.setattr(ref, "OUT", str(tmp_path / "ref"))
    ref.main()
    monkeypatch.setattr(heatmap_gallery, "kreg", types.SimpleNamespace(
        names=rk.names, get=reference_rungs, run_variant=kreg.run_variant))
    got = heatmap_gallery.main(["--device", "cpu", "--out", str(tmp_path / "port")])
    assert got["runs"] == {}  # the reference's rungs carry no kernel
    for i in (0, 1):
        want = ref_load_iteration(tmp_path / "ref" / "session" / f"iter{i}").kernels
        have = load_iteration(tmp_path / "port" / "session" / f"iter{i}").kernels
        assert [(k.name, k.variant, k.transactions, classes(k.reports)) for k in have] == \
            [(k.name, k.variant, k.transactions, classes(k.reports)) for k in want]
    assert (tmp_path / "port" / "gallery_diff.txt").read_text() == \
        (tmp_path / "ref" / "gallery_diff.txt").read_text()


def test_serve_long_context_cache_mib_is_the_reference_s(monkeypatch):
    """``bench_decode``'s cache MiB at each prefill, both models, against the
    reference's ``bench_decode`` (examples/serve_long_context.py:22-41) on
    the same configs: both hold the caches allocated at max_seq.  The
    reference also counts each attention layer's cache length, an int32
    array; the port keeps it as a Python int."""
    import jax
    import jax.numpy as jnp

    from repro.models import build_model as ref_build_model
    from repro_torch.models import build_model

    ref = reference_example("serve_long_context")
    for cfg in (serve_long_context.SSM, serve_long_context.GQA):
        ref_cfg = config_for_reference(cfg)
        ref_model = ref_build_model(ref_cfg)
        ref_params = ref_model.init(jax.random.key(0))
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        lengths = sum(
            leaf.size * leaf.dtype.itemsize
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                ref_model.init_caches(1, serve_long_context.MAX_SEQ, dtype=jnp.float32))
            if "length" in jax.tree_util.keystr(path))
        for plen in serve_long_context.PREFILLS:
            _, want = ref.bench_decode(ref_model, ref_params, plen, n_tokens=1)
            _, got = serve_long_context.bench_decode(model, plen, n_tokens=1)
            assert got * 2**20 + lengths == want * 2**20, (cfg.name, plen)


# the greedy requests of the reference's serve_lm whose tokens from its
# ``Server`` differ from its model's decode of them alone: a recorded fact of
# the reference, whose slots share one cache length
REFERENCE_SERVE_LM_DIFFERS = [2, 8]


def test_serve_lm_gives_the_reference_s_greedy_tokens(monkeypatch):
    """serve_lm on the reference's parameters gets the reference's prompts,
    and every greedy request gets the tokens of the reference's model
    decoding it alone (a batch-1 prefill then ``decode_step``)."""
    import jax
    import jax.numpy as jnp

    from repro_torch.models.model import params_from_reference

    ref = reference_example("serve_lm")
    servers = []

    class Recorded(ref.Server):
        def __init__(self, model, params, *args, **kwargs):
            super().__init__(model, params, *args, **kwargs)
            self.params, self.requests = params, []
            servers.append(self)

        def submit(self, req):
            self.requests.append(req)
            super().submit(req)

    monkeypatch.setattr(ref, "Server", Recorded)
    ref.main()
    srv = servers[0]
    state = params_from_reference(serve_lm.CONFIG, jax.tree.map(np.asarray, srv.params))

    def build(cfg, device=None, generator=None):
        model = LM(cfg, device=device)
        model.load_state_dict(state)
        return model

    monkeypatch.setattr(serve_lm, "build_model", build)
    got = serve_lm.main(["--device", "cpu"])["requests"]
    want = srv.requests
    assert [len(r.prompt) for r in got] == [len(r.prompt) for r in want]
    decode = jax.jit(srv.model.decode_step)
    differs = []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        if w.temperature != 0.0:
            continue
        caches = srv.model.init_caches(1, 128, dtype=jnp.float32)
        logits, caches = srv.model.prefill(srv.params, jnp.asarray(w.prompt)[None], caches)
        alone = [int(jnp.argmax(logits[0, -1]))]
        while len(alone) < serve_lm.MAX_TOKENS:
            logits, caches = decode(srv.params, jnp.asarray([[alone[-1]]], jnp.int32), caches)
            alone.append(int(jnp.argmax(logits[0, 0])))
        assert g.out_tokens == alone, g.rid
        if list(map(int, w.out_tokens)) != alone:
            differs.append(w.rid)
    assert differs == REFERENCE_SERVE_LM_DIFFERS
    assert sum(r.temperature == 0.0 for r in want) == 5


def test_train_lm_follows_the_reference_s_loss_curve(monkeypatch):
    import sys

    import jax

    from repro_torch.models.model import params_from_reference

    ref = reference_example("train_lm")
    first, losses = [], {}
    init_state, run = ref.init_state, ref.run

    def recorded_init(params, *a, **kw):
        first.append(jax.tree.map(np.asarray, params))  # the step donates its state
        return init_state(params, *a, **kw)

    def recorded_run(step, state, pipe, n, hooks, start_step=0):
        def record(i, st, metrics):
            losses[i] = float(metrics["loss"])

        return run(step, state, pipe, n, tuple(hooks) + (record,), start_step=start_step)

    monkeypatch.setattr(ref, "init_state", recorded_init)
    monkeypatch.setattr(ref, "run", recorded_run)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "6", "--restart-at", "3"])
    ref.main()
    state = params_from_reference(train_lm.CONFIG, first[0])

    def build(cfg, device=None, generator=None):
        model = LM(cfg, device=device)
        model.load_state_dict(state)
        return model

    monkeypatch.setattr(train_lm, "build_model", build)
    got = train_lm.main(["--device", "cpu", "--steps", "6", "--restart-at", "3"])
    want = [losses[i] for i in range(6)]
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
