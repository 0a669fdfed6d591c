"""dp×tp sharded serving and training on ``torch.distributed`` (the
reference's ``repro/parallel``): ``sharding`` (the logical-axis rule table
and the mesh context), ``state_sharding`` (the train, cache, batch and
prequant specs; cutting a tree to a rank's part and back),
``collectives`` (quantize-before-all-gather, the per-step mesh programs
and their byte meters), ``serve_mesh`` (the serving step's partition
rules, sharded step and stats merge) and ``train_mesh`` (a rank's part of
the train state and the sharded train step). The ranks themselves are
started by ``launch/mesh.py``. Importing this package starts no process
group and touches no card.
"""
