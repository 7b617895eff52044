"""The port's runtime (``repro_torch.runtime``): training loop, gradient
accumulation, compression, fault hooks and the serving ``Server``.

The ports of ``tests/test_runtime.py`` come first.  Then the port's
``Server`` is held to the JAX package's token for token (greedy, float32)
on the dense, MoE, hybrid, SSM and MLA SMOKE configs, every request of
the run included: the request that sets the shared cache length, the
shorter ones (which both packages decode at the shared length) and the
ones admitted into refilled slots.  The compression's wire values and
error buffers equal the reference's.
"""

import dataclasses
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build
from repro.parallel import compression as ref_compression
from repro.runtime import Request as RefRequest
from repro.runtime import ServeConfig as RefServeConfig
from repro.runtime import Server as RefServer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticSource, TokenPipeline
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.model import params_from_reference
from repro_torch.models.registry import config_from_reference
from repro_torch.optim import adamw, constant, cosine_warmup
from repro_torch.parallel.compression import (
    CompressionConfig,
    compress,
    decompress,
    init_error_buffer,
)
from repro_torch.runtime import (
    Preempted,
    PreemptionHandler,
    Request,
    ServeConfig,
    Server,
    StragglerMonitor,
    TrainConfig,
    build_train_step,
    init_state,
    model_loss,
    retry,
    run,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread is ~50x faster than a crowded pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
                      dtype=torch.float32)
    return cfg, build_model(cfg, generator=torch.Generator().manual_seed(0))


def _step(m, opt, tc, donate=True):
    return build_train_step(lambda p, t, l: model_loss(m, p, t, l), opt, tc, donate=donate)


def _batch(tokens, labels):
    return torch.from_numpy(tokens), torch.from_numpy(labels)


# -- ports of tests/test_runtime.py --------------------------------------------------


def test_training_reduces_loss():
    cfg, m = _tiny()
    opt = adamw(cosine_warmup(5e-3, 5, 60))
    tc = TrainConfig()
    state = init_state(dict(m.named_parameters()), opt, tc)
    step = _step(m, opt, tc)
    dc = DataConfig(global_batch=8, seq_len=24, vocab=cfg.vocab)
    pipe = TokenPipeline(SyntheticSource(dc))
    first = None
    for i, (t, l) in zip(range(40), pipe):
        state, metrics = step(state, *_batch(t, l))
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < first - 0.5


def test_grad_accum_equivalence():
    """accum=2 over batch 8 == accum=1 over the same batch (same grads)."""
    cfg, m = _tiny()
    opt = adamw(constant(1e-2))
    params = dict(m.named_parameters())
    dc = DataConfig(global_batch=8, seq_len=16, vocab=cfg.vocab)
    t, l = _batch(*next(TokenPipeline(SyntheticSource(dc))))
    st1, _ = _step(m, opt, TrainConfig(grad_accum=1), donate=False)(
        init_state(params, opt, TrainConfig()), t, l)
    st2, _ = _step(m, opt, TrainConfig(grad_accum=2), donate=False)(
        init_state(params, opt, TrainConfig(grad_accum=2)), t, l)
    for k in params:
        torch.testing.assert_close(st1.params[k], st2.params[k], atol=2e-6, rtol=2e-5)
    # donate=False left the model's own parameters as they were
    assert all(st1.params[k] is not p for k, p in params.items())


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compression_roundtrip_and_error_feedback(mode):
    cfg = CompressionConfig(mode=mode)
    g = {"w": torch.from_numpy(
        (np.random.default_rng(0).normal(size=(64, 64)) * 1e-3).astype(np.float32))}
    err = init_error_buffer(g, cfg)
    wire, err2 = compress(g, err, cfg)
    deq = decompress(wire, cfg)
    resid = float((deq["w"] + err2["w"] - g["w"]).abs().max())
    assert resid < 1e-6
    if mode == "int8":
        assert wire["w"][0].dtype == torch.int8


def test_compressed_training_converges():
    cfg, m = _tiny()
    opt = adamw(constant(5e-3))
    tc = TrainConfig(compression=CompressionConfig(mode="int8"))
    state = init_state(dict(m.named_parameters()), opt, tc)
    step = _step(m, opt, tc)
    dc = DataConfig(global_batch=8, seq_len=16, vocab=cfg.vocab)
    pipe = TokenPipeline(SyntheticSource(dc))
    losses = []
    for i, (t, l) in zip(range(30), pipe):
        state, metrics = step(state, *_batch(t, l))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(threshold=6.0, warmup=5)
    for i in range(30):
        mon.observe(i, 0.1 + 0.001 * (i % 3) if i != 20 else 0.5)
    assert any(e.step == 20 for e in mon.events)
    assert max(mon.events, key=lambda e: e.zscore).step == 20


def test_preemption_checkpoint_and_restart(tmp_path):
    cfg, m = _tiny()
    opt = adamw(constant(1e-3))
    tc = TrainConfig()
    state = init_state(dict(m.named_parameters()), opt, tc)
    step = _step(m, opt, tc)
    dc = DataConfig(global_batch=4, seq_len=16, vocab=cfg.vocab)
    pipe = TokenPipeline(SyntheticSource(dc))
    mgr = CheckpointManager(str(tmp_path))
    handler = PreemptionHandler().register(signals=(signal.SIGUSR1,))
    captured = {}

    def state_fn():
        return {"params": captured["state"].params}, {"data_step": pipe.state()}

    def capture_hook(i, st, metrics):
        captured["state"] = st
        if i == 3:
            os.kill(os.getpid(), signal.SIGUSR1)  # simulated preemption

    hooks = (capture_hook, handler.checkpoint_hook(mgr, state_fn))
    try:
        with pytest.raises(Preempted):
            run(step, state, pipe, 10, hooks)
    finally:
        handler.unregister()
    assert mgr.latest_step() == 3
    target = {"params": {k: torch.empty_like(p) for k, p in state.params.items()}}
    restored, ck, extra = mgr.restore(target)
    assert extra["data_step"] >= 4
    # the emergency checkpoint holds the parameters as they were when it ran
    for k, p in captured["state"].params.items():
        assert torch.equal(restored["params"][k], p.detach())


def test_retry_backoff():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError("transient")
        return "ok"

    assert retry(flaky, attempts=4, base_delay=0.001)() == "ok"
    assert calls["n"] == 3


def _direct_greedy(m, prompt, n, max_seq=32):
    with torch.no_grad():
        caches = m.init_caches(1, max_seq, dtype=torch.float32)
        lg, caches = m.prefill(torch.from_numpy(prompt).long()[None], caches)
        toks = [int(torch.argmax(lg[0, -1]))]
        for _ in range(n - 1):
            lg, caches = m.decode_step(torch.tensor([[toks[-1]]]), caches)
            toks.append(int(torch.argmax(lg[0, 0])))
    return toks


def test_server_matches_direct_decode():
    cfg, m = _tiny()
    prompt = np.array([3, 7, 11], np.int32)
    toks = _direct_greedy(m, prompt, 5)
    srv = Server(m, ServeConfig(batch_slots=2, max_seq=32), dtype=torch.float32)
    r0 = Request(rid=0, prompt=prompt, max_tokens=5)
    r1 = Request(rid=1, prompt=np.array([1, 2], np.int32), max_tokens=3)
    srv.submit(r0)
    srv.submit(r1)
    srv.run_until_done()
    assert r0.out_tokens == toks
    assert len(r1.out_tokens) == 3


def test_server_continuous_batching_refills():
    cfg, m = _tiny()
    srv = Server(m, ServeConfig(batch_slots=2, max_seq=32), dtype=torch.float32)
    reqs = [Request(rid=i, prompt=np.array([i + 1], np.int32), max_tokens=3)
            for i in range(5)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_done()
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == 3 for r in reqs)


# -- against the JAX package --------------------------------------------------------


def _smoke_pair(arch):
    ref_cfg = ref_get_config(arch, smoke=True)
    ref_model = ref_build(ref_cfg)
    params = ref_model.init(jax.random.key(0))
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    model = build_model(cfg)
    model.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return ref_model, params, model, cfg


# (prompt length, max_tokens) per request: request 0 sets the shared length,
# 1 and 2 are shorter, 3 and 4 go into refilled slots.  Lengths of at most 8
# keep the SMOKE SSD chunk (8) whole.
TRAFFIC = [(7, 5), (3, 3), (3, 6), (7, 3), (3, 4)]


@pytest.mark.parametrize("arch", [
    "granite-8b", "llama4-scout-17b-a16e", "jamba-v0.1-52b", "mamba2-2.7b", "deepseek-v3-671b",
], ids=["dense", "moe", "hybrid", "ssm", "mla"])
def test_server_gives_the_reference_servers_tokens(arch):
    ref_model, params, model, cfg = _smoke_pair(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in TRAFFIC]
    ref_srv = RefServer(ref_model, params, RefServeConfig(batch_slots=3, max_seq=32),
                        dtype=jnp.float32)
    srv = Server(model, ServeConfig(batch_slots=3, max_seq=32), dtype=torch.float32)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_tokens=k) for i, (p, (_, k)) in
                enumerate(zip(prompts, TRAFFIC))]
    reqs = [Request(rid=i, prompt=p, max_tokens=k) for i, (p, (_, k)) in
            enumerate(zip(prompts, TRAFFIC))]
    for a, b in zip(ref_reqs, reqs):
        ref_srv.submit(a)
        srv.submit(b)
    ref_srv.run_until_done()
    srv.run_until_done()
    assert srv.steps == ref_srv.steps
    for a, b in zip(ref_reqs, reqs):
        assert b.done and len(b.out_tokens) == b.max_tokens
        assert b.out_tokens == a.out_tokens, (arch, b.rid)


def test_server_sampling_is_seeded_and_in_the_vocabulary():
    cfg, m = _tiny()

    def serve(seed):
        srv = Server(m, ServeConfig(batch_slots=2, max_seq=32, seed=seed))
        reqs = [Request(rid=i, prompt=np.array([i + 1, 5], np.int32), max_tokens=6,
                        temperature=1.5) for i in range(3)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_done()
        return [r.out_tokens for r in reqs]

    a, b, c = serve(0), serve(0), serve(1)
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab for toks in a + c for t in toks)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("feedback", [True, False])
def test_compress_wire_values_equal_the_reference(mode, feedback):
    rng = np.random.default_rng(2)
    grads = [{"w": rng.normal(size=(32, 48)).astype(np.float32) * 1e-2,
              "b": rng.normal(size=48).astype(np.float32)} for _ in range(2)]
    rcfg = ref_compression.CompressionConfig(mode=mode, error_feedback=feedback)
    pcfg = CompressionConfig(mode=mode, error_feedback=feedback)
    rerr = ref_compression.init_error_buffer({k: jnp.asarray(v) for k, v in grads[0].items()},
                                             rcfg)
    perr = init_error_buffer({k: torch.from_numpy(v) for k, v in grads[0].items()}, pcfg)
    for g in grads:  # the second round carries the first's error
        rwire, rerr = ref_compression.compress({k: jnp.asarray(v) for k, v in g.items()}, rerr, rcfg)
        pwire, perr = compress({k: torch.from_numpy(v) for k, v in g.items()}, perr, pcfg)
        for k in g:
            if mode == "bf16":
                assert pwire[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(pwire[k].float().numpy(),
                                              np.asarray(rwire[k]).astype(np.float32))
            else:
                q, scale = pwire[k]
                np.testing.assert_array_equal(q.numpy(), np.asarray(rwire[k][0]))
                assert float(scale) == float(rwire[k][1])
            if feedback:
                np.testing.assert_array_equal(perr[k].numpy(), np.asarray(rerr[k]))
        assert (perr is None) == (rerr is None) == (not feedback)
        rdeq = ref_compression.decompress(rwire, rcfg)
        pdeq = decompress(pwire, pcfg)
        for k in g:
            np.testing.assert_array_equal(pdeq[k].numpy(), np.asarray(rdeq[k]))


def test_cpu_vector_math_is_set_up_on_import():
    """The kernels and the models make the process's first call of each
    VML function on one element (``repro_torch.cpu_math``), so no first
    call is split over threads (``tools/vml_first_call.py``)."""
    code = ("import repro_torch.{mod}; from repro_torch import cpu_math; "
            "print(cpu_math.prepare.cache_info().currsize)")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    for mod in ("kernels", "models"):
        out = subprocess.run([sys.executable, "-c", code.format(mod=mod)], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and out.stdout.strip() == "1", (mod, out.stderr)
