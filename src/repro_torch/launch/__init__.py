"""repro_torch.launch — the train and serve launchers, the mesh constructors
and the production-mesh dry-run.

    python -m repro_torch.launch.serve --arch granite-8b --smoke --device cpu
    python -m repro_torch.launch.train --arch granite-8b --smoke --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke --device cpu
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k
"""
