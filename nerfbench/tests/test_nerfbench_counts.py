"""The logical work counts: the touched-entry count against brute force on
a tiny grid, and every share of a roofline at most 100% where the time is
that of a plain CPU run of the work; a trace's busy time is the union of
its operations' intervals."""

import time

import numpy as np
import torch

from nerfbench import counts
from nerfbench.reference import grid
from nerfbench.reference.spec import make_spec

BOX = ((-1.0, -1.2, -0.5), (1.1, 0.9, 1.3))


def _spec(i_embed):
    return make_spec({"i_embed": i_embed, "n_levels": 3,
                      "feats_per_level": 2, "log2_hashmap_size": 10,
                      "finest_res": 24, "block_size": 3, "block_io": "bf16"},
                     BOX)


def _brute(x, spec):
    seen = set()
    for pt in x:
        if spec.grid == "block":
            row, p = grid.block_coords(pt[None], spec)
            for l in range(spec.n_levels):
                r, q = int(row[0, l]), p[0, l].numpy()
                base = np.floor(q).astype(int)
                for d in np.ndindex(2, 2, 2):
                    v = base + np.array(d)
                    seen.add((r, (v[0] * spec.side + v[1]) * spec.side + v[2]))
        else:
            rows, _ = grid.hash_corners(pt[None], spec)
            seen.update(int(r) for r in rows.reshape(-1))
    return len(seen)


def test_touched_count_matches_brute_force():
    g = torch.Generator().manual_seed(0)
    lo, hi = torch.tensor(BOX[0]), torch.tensor(BOX[1])
    x = lo + torch.rand((300, 3), generator=g) * (hi - lo)
    for i_embed in (1, 3):
        spec = _spec(i_embed)
        assert counts.touched_count(x, spec, block=64) == _brute(x, spec)


def test_shares_at_most_full():
    g = torch.Generator().manual_seed(1)
    lo, hi = torch.tensor(BOX[0]), torch.tensor(BOX[1])
    for i_embed in (1, 3):
        spec = _spec(i_embed)
        x = lo + torch.rand((20000, 3), generator=g) * (hi - lo)
        table = torch.rand(spec.table_shape, generator=g, requires_grad=True)
        t0 = time.perf_counter()
        feats, _ = grid.encode(x, table, spec)
        fwd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        feats.sum().backward()
        bwd_s = time.perf_counter() - t0
        touched = counts.touched_count(x, spec)
        for backward, sec in ((False, fwd_s), (True, bwd_s)):
            work = counts.encode_work(x.shape[0], touched, spec, backward)
            assert 0 < counts.least_seconds(work) <= sec
    assert counts.mlp_flops_per_sample(_spec(3)) > 0


def test_busy_is_the_union_of_intervals():
    from nerfbench import tracing

    iv = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (2.5, 2.75), (7.0, 8.0)]
    assert tracing._union_s(iv, 0.5) == (3.0 + 3.0) * 0.5
    assert tracing._union_s([], 1.0) == 0.0
    ran = []
    busy, ops = tracing.device_busy(lambda: ran.append(1), torch.device("cpu"),
                                    "unused")
    assert ran == [1] and busy >= 0.0 and ops == 0
