"""The port's runtime (``repro_torch.runtime``): training loop, gradient
accumulation, compression, fault hooks and the serving ``Server``.

The ports of ``tests/test_runtime.py`` come first.  Then every request of
the port's ``Server`` is held to the JAX package's model decoding it alone
(a batch-1 prefill then ``decode_step`` on a fresh cache, greedy, float32,
the same weights) on the dense, MoE, hybrid, SSM, MLA, enc-dec and M-RoPE
SMOKE configs and a sliding window: the first request, the shorter ones
beside it, the ones admitted into refilled slots, and a single slot that
runs more ticks than ``max_seq``.  The mixtures of experts run their
ragged dispatch there; under capacity dispatch, where a decode token's
route depends on the batch, each request's first token is its own.  The
JAX package's ``Server`` keeps one shared cache length and differs from
its own model on the requests named in :data:`REFERENCE_SERVER_DIFFERS`.
The compression's wire values and error buffers equal the reference's.
"""

import dataclasses
import functools
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build
from repro.parallel import compression as ref_compression
from repro.runtime import Request as RefRequest
from repro.runtime import ServeConfig as RefServeConfig
from repro.runtime import Server as RefServer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticSource, TokenPipeline
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.attention import attention_ref, cache_update, row_step
from repro_torch.models.model import caches_length, params_from_reference, row_positions
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
    assert r1.out_tokens == _direct_greedy(m, r1.prompt, 3)


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


@functools.lru_cache(maxsize=None)
def _smoke_pair(arch, changes=()):
    """The JAX SMOKE model of ``arch`` (with ``changes`` to its config), its
    parameters, its jitted prefill (``apply`` with a cache: the JAX enc-dec
    model has no ``prefill``) and ``decode_step``, the port's model on the
    same weights, and its config."""
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True), **dict(changes))
    ref_model = ref_build(ref_cfg)
    params = ref_model.init(jax.random.key(0))
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    model = build_model(cfg)
    model.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    prefill = jax.jit(lambda p, t, c: ref_model.apply(p, t, caches=c)[:2])
    return ref_model, params, (prefill, jax.jit(ref_model.decode_step)), model, cfg


def _reference_greedy(pair, prompt, n, max_seq=32):
    """``n`` greedy tokens of the JAX model decoding ``prompt`` alone: a
    batch-1 prefill on a fresh cache then ``decode_step``."""
    ref_model, params, (prefill, decode), _, _ = pair
    caches = ref_model.init_caches(1, max_seq, dtype=jnp.float32)
    logits, caches = prefill(params, jnp.asarray(prompt)[None], caches)
    toks = [int(jnp.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        logits, caches = decode(params, jnp.asarray([[toks[-1]]], jnp.int32), caches)
        toks.append(int(jnp.argmax(logits[0, 0])))
    return toks


def _serve(model, traffic, prompts, slots, max_seq=32):
    """The requests of ``traffic`` through a port ``Server``; the requests,
    the ``Server``'s tick count and the largest cache length any slot held
    after a tick."""
    srv = Server(model, ServeConfig(batch_slots=slots, max_seq=max_seq), dtype=torch.float32)
    reqs = [Request(rid=i, prompt=p, max_tokens=k) for i, (p, (_, k)) in
            enumerate(zip(prompts, traffic))]
    for r in reqs:
        srv.submit(r)
    longest = 0
    while srv.queue or any(r is not None for r in srv.active):
        srv.step()
        longest = max(longest, int(torch.as_tensor(caches_length(srv.caches)).max()))
    return reqs, srv.steps, longest


# (prompt length, max_tokens) per request: 0 is the longest of the first
# wave, 1 and 2 are shorter, 3 and 4 go into refilled slots (3 after a
# shorter request, 4 after a longer one).  Lengths of at most 8 keep the
# SMOKE SSD chunk (8) whole.
TRAFFIC = [(7, 5), (3, 3), (3, 6), (7, 3), (3, 4)]
# the ticks the JAX package's ``Server`` takes for TRAFFIC on 3 slots
# (checked against it in test_reference_server_differs_from_its_model_alone):
# scheduling does not depend on the architecture while no request stops early
TRAFFIC_TICKS = 7
RAGGED = (("moe_impl", "ragged"),)


def _prompts(cfg, traffic, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in traffic]


@pytest.mark.parametrize("arch,changes", [
    ("granite-8b", ()), ("llama4-scout-17b-a16e", RAGGED), ("jamba-v0.1-52b", RAGGED),
    ("mamba2-2.7b", ()), ("deepseek-v3-671b", RAGGED), ("whisper-base", ()),
    ("qwen2-vl-72b", ()), ("granite-8b", (("sliding_window", 4),)),
], ids=["dense", "moe", "hybrid", "ssm", "mla", "audio", "vlm", "window"])
def test_server_gives_the_reference_servers_tokens(arch, changes):
    """Every request, on 3 slots, gives the JAX model's tokens for it alone,
    in as many ticks as the JAX ``Server`` takes."""
    pair = _smoke_pair(arch, changes)
    prompts = _prompts(pair[4], TRAFFIC)
    reqs, steps, _ = _serve(pair[3], TRAFFIC, prompts, slots=3)
    assert steps == TRAFFIC_TICKS, arch
    for r in reqs:
        assert r.done and len(r.out_tokens) == r.max_tokens
        assert r.out_tokens == _reference_greedy(pair, r.prompt, r.max_tokens), (arch, r.rid)


@pytest.mark.parametrize("arch,changes", [("granite-8b", ()), ("deepseek-v3-671b", RAGGED)],
                         ids=["dense", "mla"])
def test_server_one_slot_past_max_seq_ticks(arch, changes):
    """One slot, max_seq 16, six requests of 3 + 8 tokens: 42 ticks in all,
    each request as the JAX model decodes it alone, and no slot's length
    ever past max_seq."""
    traffic = [(3, 8)] * 6
    pair = _smoke_pair(arch, changes)
    prompts = _prompts(pair[4], traffic, seed=5)
    reqs, steps, longest = _serve(pair[3], traffic, prompts, slots=1, max_seq=16)
    assert steps == 42 and longest <= 16
    for r in reqs:
        assert r.out_tokens == _reference_greedy(pair, r.prompt, 8, max_seq=16), (arch, r.rid)


def test_server_refuses_a_request_past_max_seq():
    """A prompt plus max_tokens past max_seq is refused at admission with
    both numbers named; one that fills max_seq exactly is served, and so
    is the queue behind the refused one."""
    cfg, m = _tiny()
    srv = Server(m, ServeConfig(batch_slots=1, max_seq=16), dtype=torch.float32)
    over = Request(rid=0, prompt=np.arange(1, 11, dtype=np.int32), max_tokens=7)
    full = Request(rid=1, prompt=np.arange(1, 11, dtype=np.int32), max_tokens=6)
    srv.submit(over)
    srv.submit(full)
    with pytest.raises(ValueError, match=r"request 0: a prompt of 10 tokens plus max_tokens 7 "
                                         r"is 17, past max_seq 16"):
        srv.step()
    assert not over.out_tokens and srv.active == [None] and srv.queue == [full]
    srv.run_until_done()
    assert full.out_tokens == _direct_greedy(m, full.prompt, 6, max_seq=16)
    assert caches_length(srv.caches).tolist() == [15]  # 10 + 6 tokens, the last unwritten


def test_server_free_slot_runs_past_max_seq():
    """A slot left free while another decodes goes on past max_seq, its
    writes there writing nothing, and the live slot is unharmed."""
    cfg, m = _tiny()
    srv = Server(m, ServeConfig(batch_slots=2, max_seq=16), dtype=torch.float32)
    long = Request(rid=0, prompt=np.array([3, 7, 11], np.int32), max_tokens=13)
    short = Request(rid=1, prompt=np.arange(5, 15, dtype=np.int32), max_tokens=2)
    srv.submit(long)
    srv.submit(short)
    srv.run_until_done()
    assert caches_length(srv.caches).tolist() == [15, 22]
    assert long.out_tokens == _direct_greedy(m, long.prompt, 13, max_seq=16)
    assert short.out_tokens == _direct_greedy(m, short.prompt, 2, max_seq=16)


# Requests of ``TRAFFIC`` on 3 slots, and of four 3 + 8 token requests on
# one slot, whose tokens from the JAX package's ``Server`` differ from its
# own model's decode of them alone (SMOKE granite-8b, greedy, float32): a
# recorded fact of the reference, whose slots share one cache length, the
# largest, and whose prefill runs the whole batch.
REFERENCE_SERVER_DIFFERS = {3: [4], 1: [2, 3]}


@pytest.mark.parametrize("slots", sorted(REFERENCE_SERVER_DIFFERS))
def test_reference_server_differs_from_its_model_alone(slots):
    """The JAX ``Server`` gives the requests named in
    REFERENCE_SERVER_DIFFERS other tokens than its model alone; the port's
    ``Server`` gives every request its model's tokens alone, in as many
    ticks as the JAX ``Server`` takes."""
    pair = _smoke_pair("granite-8b")
    ref_model, params, _, model, cfg = pair
    traffic = TRAFFIC if slots == 3 else [(3, 8)] * 4
    prompts = _prompts(cfg, traffic)
    ref_srv = RefServer(ref_model, params, RefServeConfig(batch_slots=slots, max_seq=32),
                        dtype=jnp.float32)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_tokens=k) for i, (p, (_, k)) in
                enumerate(zip(prompts, traffic))]
    for r in ref_reqs:
        ref_srv.submit(r)
    ref_srv.run_until_done()
    alone = [_reference_greedy(pair, r.prompt, r.max_tokens) for r in ref_reqs]
    assert [r.rid for r, a in zip(ref_reqs, alone) if r.out_tokens != a] == \
        REFERENCE_SERVER_DIFFERS[slots]
    reqs, steps, _ = _serve(model, traffic, prompts, slots)
    assert [r.out_tokens for r in reqs] == alone
    assert steps == ref_srv.steps  # the port's scheduling is the reference's
    if slots == 3:
        assert ref_srv.steps == TRAFFIC_TICKS


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "jamba-v0.1-52b",
                                  "deepseek-v3-671b"], ids=["moe", "hybrid", "mla"])
def test_server_capacity_dispatch_first_tokens_are_the_requests_own(arch, record_property):
    """Under capacity dispatch (the published configs') a decode token's
    route depends on the batch, as GShard's does: the first token, sampled
    at the batch-1 admission, is the request's own; how many later tokens
    agree with the JAX model's decode alone is recorded."""
    pair = _smoke_pair(arch)
    assert pair[4].moe_impl == "capacity"
    prompts = _prompts(pair[4], TRAFFIC)
    reqs, steps, _ = _serve(pair[3], TRAFFIC, prompts, slots=3)
    assert steps == TRAFFIC_TICKS
    alone = [_reference_greedy(pair, r.prompt, r.max_tokens) for r in reqs]
    assert [r.out_tokens[0] for r in reqs] == [a[0] for a in alone]
    assert all(r.done and len(r.out_tokens) == r.max_tokens for r in reqs)
    record_property("later_tokens_alike", sum(
        x == y for r, a in zip(reqs, alone) for x, y in zip(r.out_tokens[1:], a[1:])))
    record_property("later_tokens", sum(r.max_tokens - 1 for r in reqs))


# -- per-row cache lengths ----------------------------------------------------------


# a step on per-row lengths dispatches 1-3 torch ops more than on an int
# length (SMOKE dense, MLA, M-RoPE, enc-dec, window), however many layers
PER_ROW_EXTRA_OPS = 4


class _CountOps(TorchDispatchMode):
    """Counts the torch ops dispatched inside it (the host's work a step)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,changes", [
    ("granite-8b", ()), ("deepseek-v3-671b", RAGGED), ("qwen2-vl-72b", ()),
    ("whisper-base", ()), ("granite-8b", (("sliding_window", 4),)),
], ids=["dense", "mla", "vlm", "audio", "window"])
def test_per_row_lengths_equal_to_a_shared_int_decode_alike(arch, changes, record_property):
    """A decode step whose (B,) length tensor holds one value for every row
    gives the int length's logits and caches, bit for bit, and dispatches
    at most PER_ROW_EXTRA_OPS more torch ops on the host, at any depth
    (the write mask and the next lengths are built once a step)."""
    model = _smoke_pair(arch, changes)[3]
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (2, 6)))
    with torch.no_grad():
        _, caches = model.prefill(toks, model.init_caches(2, 16, dtype=torch.float32))
        per_row = [{k: (torch.full((2,), v) if k == "length" else v) for k, v in c.items()}
                   for c in caches]
        nxt = toks[:, -1:]
        with _CountOps() as int_ops:
            a, ca = model.decode_step(nxt, caches)
        with _CountOps() as row_ops:
            b, cb = model.decode_step(nxt, per_row)
    record_property("ops_int_length", int_ops.n)
    record_property("ops_per_row_lengths", row_ops.n)
    assert row_ops.n <= int_ops.n + PER_ROW_EXTRA_OPS, (row_ops.n, int_ops.n)
    assert torch.equal(a, b)
    for x, y in zip(ca, cb):
        assert int(x["length"]) == 7 and y["length"].tolist() == [7, 7]
        assert all(torch.equal(x[k], y[k]) for k in x if k != "length")


def test_per_row_writes_and_masks():
    """In a row step, row b writes at its own length, a row outside the
    buffer writes nothing, the layers' next lengths are one tensor, and
    each row's keys and positions stop at its own length."""
    rng = np.random.default_rng(6)
    buf = torch.from_numpy(rng.standard_normal((3, 5, 2, 4)).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal((3, 1, 2, 4)).astype(np.float32))
    lengths = torch.tensor([0, 4, 5])
    steps = row_step([{"k": buf, "v": buf, "length": lengths}, {"conv": buf}] * 2, lengths)
    assert steps[1] == {"conv": buf}
    out = [cache_update(c, new, -new) for c in steps[::2]]
    want = buf.clone()
    want[0, 0], want[1, 4] = new[0, 0], new[1, 0]
    assert torch.equal(out[0]["k"], want) and not torch.equal(out[0]["k"], buf)
    want[0, 0], want[1, 4] = -new[0, 0], -new[1, 0]
    assert torch.equal(out[0]["v"], want)
    assert out[0]["length"] is out[1]["length"] and out[0]["length"].tolist() == [1, 5, 6]
    with pytest.raises(ValueError, match="one token"):
        cache_update(steps[0], new.expand(3, 2, 2, 4), new.expand(3, 2, 2, 4))
    assert row_positions(torch.tensor([2, 0, 5]), 3, 2, None).tolist() == [[2, 3], [0, 1], [5, 6]]
    assert torch.equal(row_positions(4, 3, 2, None), torch.tensor([[4, 5]] * 3))
    q = torch.from_numpy(rng.standard_normal((3, 1, 4, 4)).astype(np.float32))
    lengths = torch.tensor([1, 3, 5])
    got = attention_ref(q, buf, buf, (lengths - 1)[:, None], kv_length=lengths, causal=False,
                        window=2)
    for b in range(3):
        one = attention_ref(q[b:b + 1], buf[b:b + 1], buf[b:b + 1], (lengths[b:b + 1] - 1)[:, None],
                            kv_length=int(lengths[b]), causal=False, window=2)
        torch.testing.assert_close(got[b:b + 1], one, rtol=0, atol=0)


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
