"""Launch layer: the serving and training CLIs (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``) and the
rank runtime of the dp×tp mesh and the production mesh shapes
(``launch/mesh.py``)."""
