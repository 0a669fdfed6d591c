"""dp×tp sharded serving on ``torch.distributed`` (the reference's
``repro/parallel``): ``collectives`` (quantize-before-all-gather, the
per-step mesh program and its byte meter) and ``serve_mesh`` (the mesh
spec, partition rules, the rank's sharded step and the stats merge). The
ranks themselves are started by ``launch/mesh.py``. Importing this package
starts no process group and touches no card.
"""
