"""repro_torch.launch — the train and serve drivers (one device).

    python -m repro_torch.launch.serve --arch granite-8b --smoke --device cpu
    python -m repro_torch.launch.train --arch granite-8b --smoke --device cpu
"""
