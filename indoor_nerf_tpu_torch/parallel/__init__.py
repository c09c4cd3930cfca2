"""Multi-device training and rendering over ``torch.distributed``
(``parallel/`` of the JAX package): the mesh and the sharded state and
step (``shard.py``), the level-sharded grid encodes (``tp.py``), the
sharded image renderer (``sp.py``), the collectives XLA inserts for the
JAX package (``collectives.py``) and ``dryrun_multichip`` (``dryrun.py``).
"""
