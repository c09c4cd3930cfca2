"""The rows the flagship path feeds the encode kernels.

``tent_contract``, ``table_scatter`` and ``group_scatter`` behave
differently on uniformly random rows (the worst case for locality, which no
path produces) and on the rows of a real render or step, where the samples
of a ray run through a few tiles. ``chip_smoke.py`` and the ``cuda`` tests
time and check the kernels on both; this module records the path's own
streams from the entry points:

- ``serving_stream``: the first ``tent_contract`` call of a test-mode
  render of 20 image rows x 800 columns through the middle of an 800x800
  view of the synthetic scene (16,000 rays x 32 samples x 8 levels);
- ``training_stream``: the ``table_scatter`` call of one real training
  step on that scene past the grid warm-up (4,096 rays x 32 x 8, the
  step's own cotangent);
- ``grouped_stream``: the ``grouped_scatter`` call of one such step with
  ``--ray_groups 4,4,2,2,1,1,1,1`` (the cotangent and the forward's lattice
  coordinates, 720,896 groups).

``count_reductions`` and ``count_group_reductions`` count, from a stream's
inputs, the atomic reductions the scatters need for it.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np

FLAGSHIP_FLAGS = ["--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
                  "--white_bkgd"]
GROUPS = (4, 4, 2, 2, 1, 1, 1, 1)  # the 8-level --ray_groups of the help text
GROUP_FLAGS = FLAGSHIP_FLAGS + ["--ray_groups", ",".join(map(str, GROUPS))]
SERVE_ROWS, SERVE_WIDTH = 20, 800  # 16,000 rays of an 800x800 view
WARM_STEPS = 10  # past the grid warm-up (8 steps), before the refresh at 16


@contextlib.contextmanager
def record_calls(name: str):
    """Record the ``(args, kwargs)`` of every call the encode makes to the
    op ``name`` of ``ops/blockhash.py`` (``tent_contract``,
    ``table_scatter``, ``grouped_scatter``); the op still runs."""
    from indoor_nerf_tpu_torch.ops import blockhash

    calls = []
    real = getattr(blockhash, name)

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    with mock.patch.object(blockhash, name, recorder):
        yield calls


def serving_stream(device):
    """The arguments ``(table, flat_row, p, side, F)`` of the first
    ``tent_contract`` call of a serving render: SERVE_ROWS rows through the
    middle of an 800x800 test view, the seeded untrained field and the full
    grid that ``serve.build`` serves."""
    import torch

    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import init_field_params, serving_params
    from indoor_nerf_tpu_torch.ops.occupancy import init_occupancy
    from indoor_nerf_tpu_torch.render.renderer import make_image_renderer
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    cli = parse_args(FLAGSHIP_FLAGS)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    gen = torch.Generator(device=device).manual_seed(cli.seed)
    params = serving_params(init_field_params(gen, cfg.render.field, device),
                            cfg.render.field)
    occ = init_occupancy(cfg.render.occupancy, device)
    W = SERVE_WIDTH
    focal = scene.hwf[2] * (W / scene.hwf[1])
    # The principal point of the full image: rows 390..409 of its 800.
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * SERVE_ROWS], [0, 0, 1]])
    renderer = make_image_renderer(cfg.render.test_mode(), SERVE_ROWS, W,
                                   tile_rays=SERVE_ROWS * W)
    with record_calls("tent_contract") as calls:
        renderer(params, scene.poses[scene.i_test[0]], K, scene.near,
                 scene.far, occ)
    args, kwargs = calls[0]
    if kwargs or len(args) != 5:
        raise AssertionError("the encode calls tent_contract(table, flat_row, "
                             "p, side, F)")
    return args


def _backward_stream(device, flags, name, n_args):
    """The positional arguments of the one call that the backward of a
    training step under the command line ``flags`` makes to the op ``name``
    of ``ops/blockhash.py``, WARM_STEPS steps after a seeded start."""
    import torch

    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    cli = parse_args(flags)
    cfg, batch = one_batch(cli, device)
    state = init_train_state(torch.Generator(device=device).manual_seed(cli.seed),
                             cfg, device)
    gen = torch.Generator(device=device).manual_seed(cli.seed + 1)
    for _ in range(WARM_STEPS):
        state, _ = train_step(state, batch, cfg, gen)
    with record_calls(name) as calls:
        train_step(state, batch, cfg, gen)
    if len(calls) != 1 or calls[0][1] or len(calls[0][0]) != n_args:
        raise AssertionError(f"the step calls {name} once with {n_args} "
                             f"positional arguments, got {len(calls)} calls")
    return calls[0][0]


def training_stream(device):
    """The arguments ``(g, p, flat_row, n_rows, side, lpf, dtype)`` of the
    ``table_scatter`` call of one flagship training step on the
    synthetic scene, WARM_STEPS steps after a seeded start."""
    return _backward_stream(device, FLAGSHIP_FLAGS, "table_scatter", 7)


def grouped_stream(device, flags=GROUP_FLAGS):
    """The arguments ``(g, v0, w, level_ids, config, groups, n_rows)`` of the
    ``grouped_scatter`` call of one grouped training step (the command line
    ``flags``: the flagship with ``--ray_groups 4,4,2,2,1,1,1,1`` on the
    synthetic scene; the CPU tests pass a small one), WARM_STEPS steps
    after a seeded start."""
    return _backward_stream(device, flags, "grouped_scatter", 7)


def count_reductions(g, p, side, dtype):
    """``(scalar, vector)``: the scalar f32 atomics that one thread per (row,
    feature) needs for these inputs (one per nonzero rounded entry), and
    the vector reductions that the rule of ``csrc/table_scatter.cu`` needs
    (one per vertex and group of 4, 2 or 1 adjacent features with a nonzero
    entry). A model of that rule computed from the inputs, not a count read
    from the card; every row is taken to be in range."""
    import torch

    M, F = g.shape
    vec = 4 if F % 4 == 0 else 2 if F % 2 == 0 else 1
    i0 = torch.clamp(torch.floor(p), 0, side - 2)
    t = torch.stack([torch.clamp_min(1.0 - torch.abs(i0 - p), 0.0),
                     torch.clamp_min(1.0 - torch.abs(i0 + 1.0 - p), 0.0)], -1)
    e = g[:, :, None] * t[:, None, 0, :]  # [M, F, 2]
    e = e[..., None] * t[:, None, 1, None, :]  # [M, F, 2, 2]
    e = e[..., None] * t[:, None, 2, None, None, :]  # [M, F, 2, 2, 2]
    if dtype != torch.float32:
        e = e.to(dtype).to(torch.float32)
    nonzero = (e != 0).reshape(M, F // vec, vec, 8)
    return int(nonzero.sum()), int(nonzero.any(2).sum())


def count_group_reductions(g, p, groups, side, lpf, dtype):
    """``count_reductions`` for merged groups, ``(scalar, vector)``: ``g``
    ``[Rn, S, L*F]`` and ``p`` ``[Rn, S, L, 3]`` (each member's position in
    its group's anchor tile) as ``ops/group_scatter.py::group_scatter``
    takes them. Scalar: one f32 atomic per nonzero rounded entry of a
    group's merged row (one thread per (group, feature)). Vector: the rule
    of ``csrc/group_scatter.cu``, one reduction per vertex of the group's
    merged row and group of 4, 2 or 1 adjacent features with a nonzero
    entry, so a vertex that two members bracket counts once. A model
    computed from the inputs (through the dense merged rows), not a count
    read from the card; every row is taken to be in range."""
    from indoor_nerf_tpu_torch.ops.group_scatter import merged_rows

    F = g.shape[-1] // p.shape[2]
    vec = 4 if F % 4 == 0 else 2 if F % 2 == 0 else 1
    scalar = vector = 0
    for _, _, rows in merged_rows(g, p, groups, side, lpf, dtype):
        nonzero = (rows != 0).reshape(-1, F // vec, vec, lpf)
        scalar += int(nonzero.sum())
        vector += int(nonzero.any(2).sum())
    return scalar, vector
