"""GPipe-style pipeline parallelism over a mesh dim (point-to-point sends).

The port of the JAX package's ``repro/parallel/pipeline.py``.  Each rank
along the ``stage`` dim holds one stage's parameters; the schedule runs
M microbatches through S stages in M + S - 1 ticks, handing each tick's
activation to the next stage around the ring (``batch_isend_irecv`` over
the stage dim's group, the reference's ``ppermute``).  The bubble
fraction is (S-1)/(M+S-1) — reported by :func:`bubble_fraction` so a
launcher can size microbatches.

As in the reference, the default dry-run cells use the pod axis for
data parallelism, so this module is exercised by its own tests.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

PyTree = Any


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def pipeline(
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    mesh: Any,
    axis: str = "stage",
):
    """Build a pipelined forward: (stacked_stage_params, microbatches) -> out.

    ``stage_fn(params_i, x)`` is one stage's computation; all stages must
    share the activation shape.  ``stacked_stage_params`` (a tensor, or a
    dict of them) has a leading stage dim: a DTensor sharded over
    ``axis`` (each rank holds its stage's slice) or the same full tensor
    on every rank.  ``microbatches`` is (M, mb, ...), the same on every
    rank.  Every rank returns the (M, mb, ...) outputs of the last stage.
    """
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)

    def mine(p: torch.Tensor) -> torch.Tensor:
        """This stage's slice: a sharded DTensor's one local row, or a row
        of the full tensor."""
        return p.to_local()[0] if hasattr(p, "to_local") else p[stage]

    def run(params_stk: PyTree, mbs: torch.Tensor) -> torch.Tensor:
        params_i = ({k: mine(v) for k, v in params_stk.items()}
                    if isinstance(params_stk, dict) else mine(params_stk))
        mbs = _local(mbs)
        m = mbs.shape[0]
        buf = torch.zeros_like(mbs[0])
        outs = torch.zeros_like(mbs)
        for t in range(m + n_stages - 1):
            # stage 0 injects microbatch t (while there is one)
            x_in = mbs[min(t, m - 1)] if stage == 0 else buf
            y = stage_fn(params_i, x_in)
            # the last stage emits microbatch t - (S-1)
            out_idx = t - (n_stages - 1)
            if stage == n_stages - 1 and out_idx >= 0:
                outs[out_idx] = y
            # move activations one stage forward
            recv = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group),
            ])
            for r in reqs:
                r.wait()
            buf = recv
        # only the last stage holds real outputs; zero the rest and sum
        # over the stage group to hand them to every stage
        if stage != n_stages - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
        return outs

    return run
