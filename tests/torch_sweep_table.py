"""The port's op-level sweep beside the JAX package's HLO sweep.

For each registered model at its profile shapes, forward and
forward+backward: the reference's ``hlo_sweep`` counts (FLOPs, bytes)
and the dot FLOPs alone within them; the port's ``op_sweep`` counts
(FLOPs, bytes) and the matrix products' FLOPs alone within them.  For a
ragged MoE the reference's dot count includes the dense lowering of
``jax.lax.ragged_dot`` on the CPU, which contracts every expert with
every routed row; ``ragged_excess`` is that surplus, from the shapes.

Run from the root of the repository (imports both packages):

    PYTHONPATH=src:tests python tests/torch_sweep_table.py
"""

import contextlib

from repro.core import hlo_cost
from repro.core import model_profile as ref_mp
from repro.models.registry import MODELS as REF_MODELS
from repro_torch.core.model_profile import op_sweep
from repro_torch.models.registry import get_model


@contextlib.contextmanager
def dots_only():
    """Within it, the reference's HLO cost counts the dots' FLOPs alone
    (elementwise results count 0; trip counts still apply)."""
    orig = hlo_cost.HloCostModel._instr_cost

    def only_dots(self, ins):
        cost = orig(self, ins)
        if ins.op != "dot":
            cost.flops = 0.0
        return cost

    hlo_cost.HloCostModel._instr_cost = only_dots
    try:
        yield
    finally:
        hlo_cost.HloCostModel._instr_cost = orig


def ragged_excess(cfg, batch: int, seq: int, backward: bool = False) -> float:
    """FLOPs the reference's CPU lowering of ``ragged_dot`` adds over the
    routed products: (E - 1) x the gate, up and down products of the
    T*k routed rows, per MoE layer (0 for the capacity dispatch); with
    ``backward`` three times that (each product's two gradients)."""
    if not cfg.n_experts or cfg.moe_impl != "ragged":
        return 0.0
    n_moe = sum(1 for kind in cfg.layout() if kind.ffn == "moe")
    rows = batch * seq * cfg.top_k
    fwd = n_moe * 3 * 2 * rows * cfg.d_model * cfg.d_ff * (cfg.n_experts - 1)
    return float(3 * fwd if backward else fwd)


def row(name: str, backward: bool) -> dict:
    entry = REF_MODELS[name]
    ref = ref_mp.hlo_sweep(entry.config, entry.batch, entry.seq, backward=backward)
    with dots_only():
        ref_dots = ref_mp.hlo_sweep(entry.config, entry.batch, entry.seq, backward=backward)
    port_entry = get_model(name)
    port = op_sweep(port_entry.config, port_entry.batch, port_entry.seq, backward=backward)
    return {
        "model": name,
        "backward": backward,
        "ref_flops": ref["cost"]["flops"],
        "ref_bytes": ref["cost"]["bytes"],
        "ref_dot_flops": ref_dots["cost"]["flops"],
        "ragged_excess": ragged_excess(entry.config, entry.batch, entry.seq, backward),
        "port_flops": port["cost"]["flops"],
        "port_bytes": port["cost"]["bytes"],
        "port_product_flops": port["cost"]["product_flops"],
    }


def main() -> None:
    print("| model | pass | reference flops | port flops | reference dot flops "
          "(less ragged excess) | port product flops | reference bytes | port bytes |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for name in REF_MODELS:
        for backward in (False, True):
            r = row(name, backward)
            dots = r["ref_dot_flops"] - r["ragged_excess"]
            print(f"| {name} | {'fwd+bwd' if backward else 'fwd'} | {r['ref_flops']:.4e} | "
                  f"{r['port_flops']:.4e} ({r['port_flops'] / r['ref_flops']:.3f}) | "
                  f"{r['ref_dot_flops']:.4e} ({dots:.4e}) | {r['port_product_flops']:.4e} "
                  f"({r['port_product_flops'] / dots:.3f}) | {r['ref_bytes']:.4e} | "
                  f"{r['port_bytes']:.4e} |")


if __name__ == "__main__":
    main()
