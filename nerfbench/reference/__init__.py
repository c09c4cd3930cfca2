"""The plain reference of the benchmark: the radiance field, its renderer,
its losses and its optimizer, written once more in plain PyTorch float32
(TF32 off) from the published description and the configuration's values.

It imports nothing of the program under test and takes none of its
tensors: the inputs (weights, scene, ray batches, random draws) come from
the benchmark, and every derived quantity (the grid geometry, the
occupancy grid, the k-means frame) is worked out again here. Where the
program's numerics are part of the configuration (a bfloat16 row gather, a
bfloat16 rounding of the table's cotangent) the reference rounds the same
way. ``spec.py`` reads a configuration, ``grid.py`` holds the two encodes,
``model.py`` the network, ``render.py`` the samplers and compositing,
``priors.py`` the structural losses and ``step.py`` the training step and
RAdam.
"""
