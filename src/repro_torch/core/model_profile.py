"""Whole-model profiling: one iteration per model, per-layer attribution.

The kernel registry profiles kernels in isolation; this module profiles a
*model*: every kernel its forward (and, optionally, backward) pass runs,
into ONE session iteration whose manifest carries per-layer attribution.

1. **Kernel-call interception.**  ``intercept()`` monkeypatches the
   kernels' spec builders (``flash.flash_spec``, ``gemm.gemm_v01_spec``,
   ...) so every spec built while a ``layer_scope`` is active is recorded
   as a :class:`KernelCall` with the layer path that built it.
   ``discover()`` walks the model's ``layout()`` under the shim, layer by
   layer and block kind by block kind, so the specs that get profiled are,
   verifiably, the ones the derivation built, each attributed to its layer.
2. **Launches.**  On the card, each forward kernel is launched at the
   model's shapes on seeded inputs, checked against its plain version and
   timed (``repro_torch.kernels.run_variant``), and the record goes beside
   its heat map.  Within one model every kernel of a kind has one shape,
   so the kernels of a kind share the first one's measurement, and their
   records say so (``shared_with``).  ``.bwd`` kernels are spec-only: no
   backward kernel exists for them.
3. **One iteration.**  Every discovered kernel is profiled through
   :func:`repro_torch.core.session.profile_kernel` and persisted with a
   per-layer rollup table, validated on write as an exact partition, so
   per-layer transfer totals sum to the iteration total by construction.
4. **The op-level sweep** (:func:`op_sweep`, the JAX package's HLO
   sweep): the model's forward (with ``backward``, its loss and the
   gradients) runs once on meta tensors, which allocate nothing, under
   :func:`repro_torch.core.op_cost.count`; its FLOPs, bytes and
   collectives land in the manifest's ``layers.hlo`` block,
   marked ``"source": "torch-ops"`` (the reference's blocks are XLA's).

Discovered kernels are stamped with ``model.<model>.<kind>`` family refs
(``repro_torch.kernels.get`` delegates those to
``repro_torch.models.registry.kernel_entry``), so ``cuthermo profile -k
model.transformer-tiny.attn:wide-kv`` profiles one rung of a model's kind.

The collection cache applies (``cache``): an unchanged model re-profiles
without a walk, and its
kernels are launched again.  Sharded collection applies (``workers``):
the walks run on a spawn pool, the launches in this process.  The run is
preemption-safe: a journal (:data:`MODEL_JOURNAL`) at the session root
lets ``--resume`` finish a preempted run with the kernels (and the runs
measured on the card) the preempted one already profiled.

Backward kernels are a *model*: attention/GEMM backward passes stream the
same operand set with the data direction flipped (activations re-read,
gradients written where inputs were read), so ``bwd_spec`` derives the
backward footprint by swapping load/store kinds on the forward spec.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.cache import CollectionCache
from repro_torch.core.collector import KernelSpec
from repro_torch.core.session import (
    Iteration,
    ProfileSession,
    ProfiledKernel,
    load_iteration,
    profile_kernel,
)
from repro_torch.core.trace import GridSampler
from repro_torch.runtime.fault import Preempted

__all__ = [
    "DiscoveredKernel",
    "KernelCall",
    "MODEL_JOURNAL",
    "bwd_spec",
    "discover",
    "intercept",
    "iteration_transactions",
    "layer_scope",
    "layers_table",
    "op_sweep",
    "profile_model",
]


#: Name of the resumable-run journal ``profile_model`` keeps at the
#: session root while a whole-model profile is in flight.
MODEL_JOURNAL = "model.journal.json"


# ---------------------------------------------------------------------------
# the interception shim
# ---------------------------------------------------------------------------

#: Layer path active for spec builds on this thread ("" = no scope:
#: builder calls are NOT recorded, so registry builds stay silent).
_LAYER: contextvars.ContextVar[str] = contextvars.ContextVar(
    "cuthermo_layer", default=""
)


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One intercepted spec-builder call, attributed to a layer."""

    layer: str  # layer path active at build time ("layer0", "head", ...)
    entry: str  # "module:function" of the kernels' entry point
    spec: KernelSpec


@contextlib.contextmanager
def layer_scope(path: str):
    """Attribute spec builds inside this block to layer ``path``."""
    token = _LAYER.set(path)
    try:
        yield
    finally:
        _LAYER.reset(token)


def _entry_points() -> Tuple[Tuple[object, str], ...]:
    """The kernels' spec builders the model derivation goes through."""
    from repro_torch.kernels import flash, gemm, gmm, ssd

    return (
        (flash, "flash_spec"),
        (gemm, "gemm_v01_spec"),
        (gemm, "gemm_v02_spec"),
        (gmm, "gmm_spec"),
        (ssd, "ssd_chunk_spec"),
    )


@contextlib.contextmanager
def intercept():
    """Record every layer-scoped spec build into the yielded list.

    Monkeypatches the spec-builder entry points for the duration of the
    block (always restored); a build with no active :func:`layer_scope`
    passes through unrecorded.
    """
    calls: List[KernelCall] = []
    patched: List[Tuple[object, str, object]] = []

    def _wrap(module, fn_name, fn):
        def shim(*args, **kwargs):
            spec = fn(*args, **kwargs)
            layer = _LAYER.get()
            if layer:
                calls.append(
                    KernelCall(
                        layer=layer,
                        entry=f"{module.__name__}:{fn_name}",
                        spec=spec,
                    )
                )
            return spec

        shim.__name__ = fn_name
        shim.__wrapped__ = fn
        return shim

    try:
        for module, fn_name in _entry_points():
            fn = getattr(module, fn_name)
            patched.append((module, fn_name, fn))
            setattr(module, fn_name, _wrap(module, fn_name, fn))
        yield calls
    finally:
        for module, fn_name, fn in patched:
            setattr(module, fn_name, fn)


# ---------------------------------------------------------------------------
# discovery
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiscoveredKernel:
    """One kernel of a model pass, attributed and profile-ready."""

    name: str  # manifest name: "layer0.attn", "head.unembed", "+ .bwd"
    layer: str  # layer path: "layer0" ... "head"
    kind: str  # 'attn' | 'mlp' | 'moe' | 'ssm' | 'unembed'
    family: str  # registry ref: "model.<model>.<kind>"
    spec: KernelSpec  # source-stamped
    entry: str  # intercepted entry point ("module:function")
    backward: bool = False


def bwd_spec(cfg, kind: str, batch: int, seq: int, rung: int = 0) -> KernelSpec:
    """Backward-pass footprint of one derived kernel (kind-swapped).

    Loads become stores and vice versa; scratch accumulators are
    direction-free and stay put.
    """
    from repro_torch.models.registry import kind_spec

    fwd = kind_spec(cfg, kind, batch, seq, rung=rung)
    flipped = {"load": "store", "store": "load"}
    operands = tuple(
        dataclasses.replace(op, kind=flipped.get(op.kind, op.kind))
        for op in fwd.operands
    )
    return dataclasses.replace(fwd, name=f"{fwd.name}_bwd", operands=operands)


def _layer_kinds(cfg) -> List[Tuple[str, str]]:
    """(layer path, kernel kind) pairs of one forward pass, in order."""
    from repro_torch.models.registry import _FFN_KIND, _MIXER_KIND

    pairs: List[Tuple[str, str]] = []
    for i, block in enumerate(cfg.layout()):
        path = f"layer{i}"
        pairs.append((path, _MIXER_KIND[block.mixer]))
        ffn = _FFN_KIND[block.ffn]
        if ffn is not None:
            pairs.append((path, ffn))
    pairs.append(("head", "unembed"))
    return pairs


def discover(
    model_name: str,
    cfg,
    batch: int,
    seq: int,
    backward: bool = False,
    *,
    default_shapes: bool = True,
) -> List[DiscoveredKernel]:
    """Walk one model pass and return its kernels with layer attribution.

    Runs the per-layer derivation under :func:`intercept`, so every
    returned spec is one the shim observed being built inside its layer's
    scope.  ``backward=True`` appends a ``.bwd`` (kind-swapped) kernel per
    forward kernel.  Specs are source-stamped: with the registry's
    ``model.…:<rung>`` ref when the config and shapes are the registry
    defaults (``default_shapes``), otherwise with the builder triple.
    """
    from repro_torch.models.registry import _KIND_RUNGS, kind_spec

    pairs = _layer_kinds(cfg)
    with intercept() as calls:
        for path, kind in pairs:
            with layer_scope(path):
                kind_spec(cfg, kind, batch, seq)
    if len(calls) != len(pairs):  # the shim is the source of truth
        raise RuntimeError(
            f"kernel interception out of sync: walked {len(pairs)} "
            f"layer kinds but recorded {len(calls)} builder calls"
        )
    discovered: List[DiscoveredKernel] = []
    for (path, kind), call in zip(pairs, calls):
        if default_shapes:
            source: object = f"model.{model_name}.{kind}:{_KIND_RUNGS[kind][0][0]}"
        else:
            source = (
                "repro_torch.models.registry:kind_spec",
                (cfg, kind, batch, seq),
                {"rung": 0},
            )
        discovered.append(
            DiscoveredKernel(
                name=f"{path}.{kind}",
                layer=path,
                kind=kind,
                family=f"model.{model_name}.{kind}",
                spec=dataclasses.replace(call.spec, source=source),
                entry=call.entry,
            )
        )
    if backward:
        for d in list(discovered):
            spec = bwd_spec(cfg, d.kind, batch, seq)
            discovered.append(
                dataclasses.replace(
                    d,
                    name=f"{d.name}.bwd",
                    spec=dataclasses.replace(
                        spec,
                        source=(
                            "repro_torch.core.model_profile:bwd_spec",
                            (cfg, d.kind, batch, seq),
                            {"rung": 0},
                        ),
                    ),
                    backward=True,
                )
            )
    return discovered


# ---------------------------------------------------------------------------
# rollup + the profile entry point
# ---------------------------------------------------------------------------


def layers_table(
    discovered: Sequence[DiscoveredKernel],
    profiled: Sequence[ProfiledKernel],
) -> List[Dict]:
    """Roll profiled kernels up into the per-layer table.

    One row per layer path, in first-seen order; each row's
    ``transactions`` is the sum over its member kernels (the partition
    invariant ``session._validate_layers`` re-checks on write).
    """
    by_name = {pk.name: pk for pk in profiled}
    rows: Dict[str, Dict] = {}
    for d in discovered:
        pk = by_name[d.name]
        row = rows.setdefault(
            d.layer,
            {
                "path": d.layer,
                "kinds": [],
                "kernels": [],
                "transactions": 0,
                "patterns": [],
            },
        )
        if d.kind not in row["kinds"]:
            row["kinds"].append(d.kind)
        row["kernels"].append(d.name)
        row["transactions"] += pk.transactions
        for r in pk.reports:
            rd = r.as_dict()
            row["patterns"].append(
                [d.name, str(rd.get("region", "")), str(rd.get("pattern", ""))]
            )
    return list(rows.values())


def iteration_transactions(it: Iteration) -> int:
    """Total modeled transfers across an iteration's kernels."""
    return sum(pk.transactions for pk in it.kernels)


def _commit_journal(path: Path, journal: Dict) -> None:
    """Atomically (re)write the model-run journal (temp + rename)."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(journal, indent=2) + "\n")
    os.replace(tmp, path)


def _load_partial(sess: ProfileSession, name: str, overrides, backward):
    """Validate a resume journal and load its partial iteration's kernels.

    Returns ``{kernel name: ProfiledKernel}`` of the work the preempted
    run already flushed (empty when it was preempted before any kernel
    finished).  Raises ``ValueError`` (the CLI's exit 2) when there is
    nothing to resume or the journaled run does not match the requested
    one: resuming another model would splice foreign heat maps in.
    """
    jpath = sess.root / MODEL_JOURNAL
    if not jpath.is_file():
        raise ValueError(
            f"{sess.root}: nothing to resume (no {MODEL_JOURNAL}; the "
            "previous run either completed or never started)"
        )
    try:
        journal = json.loads(jpath.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"{jpath}: unreadable model journal ({e})") from e
    want = {"model": name, "overrides": list(overrides),
            "backward": bool(backward)}
    got = {k: journal.get(k) for k in want}
    if journal.get("format") != "cuthermo-model-journal" or got != want:
        raise ValueError(
            f"{jpath}: journaled run {got} does not match the requested "
            f"run {want}; re-run without --resume to start over"
        )
    partial = journal.get("partial")
    if not partial:
        return {}
    it = load_iteration(sess.root / partial)
    return {pk.name: pk for pk in it.kernels}


def op_sweep(cfg, batch: int, seq: int, backward: bool = False) -> Dict:
    """Run the model pass once on meta tensors and count what it dispatches.

    Builds the model on the ``meta`` device, where tensors carry shapes
    and dtypes and no values, so nothing is allocated whatever the
    model's size (the reference lowers over abstract parameters alike).
    It runs the forward on (batch, seq) tokens (or, with ``backward``,
    the loss and ``torch.autograd.grad`` over every parameter) under
    :func:`repro_torch.core.op_cost.count`.  The counts depend on shapes
    alone: the dropless MoE, whose group sizes are data, counts the same
    for any split of its rows (:func:`repro_torch.models.moe.moe_apply_ragged`).
    Returns the JSON-ready ``layers.hlo`` manifest block, with the keys
    the reference's has and ``"source": "torch-ops"``; its ``heat`` is the
    reference's level-3 block (:meth:`repro_torch.core.op_cost.OpCost.heat`).
    """
    import torch

    from repro_torch.core import op_cost
    from repro_torch.models import build_model

    model = build_model(cfg, device="meta")
    tokens = torch.zeros((batch, seq), dtype=torch.long, device="meta")
    if backward:
        labels = torch.zeros_like(tokens)

        def run():
            loss, _ = model.loss(tokens, labels)
            return torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    else:

        def run():
            with torch.no_grad():
                return model.apply(tokens)[0]

    _, cost = op_cost.count(run)
    return {
        "backward": bool(backward),
        "source": "torch-ops",
        "heat": cost.heat(),
        "cost": cost.as_dict(),
    }


def profile_model(
    name: str,
    out: Union[str, Path],
    *,
    overrides: Sequence[str] = (),
    backward: bool = False,
    sampler: Optional[GridSampler] = None,
    label: Optional[str] = None,
    note: str = "",
    device: str = "cuda",
    cache: Union[None, str, Path, CollectionCache] = None,
    workers: int = 1,
    fault_plan=None,
    preemption=None,
    resume: bool = False,
    hlo: bool = True,
) -> Iteration:
    """Profile one registered model into a session iteration.

    Discovers the model's kernels per layer (:func:`discover`), launches
    each forward kind once on ``device`` (``run_variant``: on the CPU the
    plain version runs and nothing is timed), profiles each kernel's spec
    (full grid unless ``sampler`` says otherwise), and persists everything
    as the next iteration of the session at ``out`` with the validated
    per-layer table, then runs the op-level sweep (:func:`op_sweep`, on
    meta tensors; ``hlo=False`` skips it).
    ``cache`` (a CollectionCache, or a directory for
    one) serves unchanged heat maps; the launches are made every time.
    ``workers`` shards the walks over a spawn pool (``fault_plan``
    injects faults into it); the launches stay in this process.  Returns
    the loaded :class:`Iteration` (its ``.layers`` carries the table).

    The run is preemption-safe: :data:`MODEL_JOURNAL` lives at the
    session root while it is in flight, and when ``preemption`` (e.g. a
    :class:`repro_torch.runtime.fault.PreemptionHandler`) reports
    ``requested`` between kernels, the kernels profiled so far are
    flushed as a *partial* iteration, the journal names it, and
    :class:`~repro_torch.runtime.fault.Preempted` is raised.
    ``resume=True`` picks such a run up: the journal is checked against
    the requested arguments, the partial iteration's kernels (heat maps
    and the runs measured on the card) are reused verbatim, and only the
    rest is profiled, so the heat maps equal an uninterrupted run's.

    Raises ``KeyError`` for an unknown model and ``ValueError`` for a
    malformed override or an invalid resume (the CLI maps both to exit
    2), and ``repro_torch.kernels.KernelMismatch`` when a kernel
    disagrees with its plain version.
    """
    from repro_torch.kernels import run_variant
    from repro_torch.models.registry import apply_overrides, get_model, kind_variant

    entry = get_model(name)
    cfg = apply_overrides(entry.config, overrides)
    batch, seq = entry.batch, entry.seq
    discovered = discover(
        name, cfg, batch, seq, backward=backward, default_shapes=not overrides
    )
    with ProfileSession(
        out, cache=cache, workers=workers, fault_plan=fault_plan
    ) as sess:
        done: Dict[str, ProfiledKernel] = (
            _load_partial(sess, name, overrides, backward) if resume else {}
        )
        journal: Dict[str, object] = {
            "format": "cuthermo-model-journal",
            "version": 1,
            "model": name,
            "overrides": list(overrides),
            "backward": bool(backward),
            "partial": None,
        }
        jpath = sess.root / MODEL_JOURNAL
        _commit_journal(jpath, journal)
        collector = sess.collector()
        measured: Dict[str, Tuple[str, Mapping]] = {}  # kind -> (kernel, run)
        profiled: List[ProfiledKernel] = []
        for d in discovered:
            if d.name in done:
                pk = done[d.name]
                if pk.run and not pk.run.get("shared_with"):
                    measured.setdefault(d.kind, (d.name, pk.run))
                profiled.append(pk)
                continue
            if preemption is not None and getattr(
                preemption, "requested", False
            ):
                # flush what we have as a partial iteration, so --resume
                # only pays for the rest
                if profiled:
                    it = sess.add_iteration(
                        profiled,
                        label=f"model-{name}-partial",
                        note=(
                            f"preempted after {len(profiled)}/"
                            f"{len(discovered)} kernels; resumable"
                        ),
                    )
                    journal["partial"] = it.path.name
                    _commit_journal(jpath, journal)
                raise Preempted(
                    f"model profile of {name} preempted after "
                    f"{len(profiled)}/{len(discovered)} kernels; "
                    "resume with --resume"
                )
            run = None
            if not d.backward:
                if d.kind in measured:
                    first, rec = measured[d.kind]
                    run = dict(rec, shared_with=first)
                else:
                    run = run_variant(
                        kind_variant(cfg, d.kind, batch, seq), device
                    )
                    measured[d.kind] = (d.name, run)
            profiled.append(
                profile_kernel(
                    d.spec,
                    sampler or GridSampler(None),
                    None,
                    name=d.name,
                    variant=f"{d.family}:{'bwd' if d.backward else 'fwd'}",
                    run=run,
                    collector=collector,
                    cache=sess.cache,
                )
            )
        layers = {
            "model": name,
            "batch": batch,
            "seq": seq,
            "overrides": list(overrides),
            "table": layers_table(discovered, profiled),
        }
        if hlo:
            layers["hlo"] = op_sweep(cfg, batch, seq, backward=backward)
        it = sess.add_iteration(
            profiled,
            label=label or f"model-{name}",
            note=note or f"whole-model profile of {name}",
            layers=layers,
        )
        jpath.unlink(missing_ok=True)
        return it
