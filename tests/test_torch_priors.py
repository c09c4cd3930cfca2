"""Port parity: the structural priors (losses/priors.py) against the JAX
package's, each function on the same numpy inputs and the same draws (the
JAX key's draws replayed into the port's ``draws``).

Masks, counts and chosen indices are held exactly; the frame to 1e-5 (the
port's polar factor by Newton steps against the JAX SVD: both round in
f32); the losses to 1e-6 relative where both sides get the same inputs,
frame included, plus one f32 ulp of a unit term times the loss weight
absolute: XLA's rsqrt on the CPU is not correctly rounded (about one value
in seven is one ulp off), and ``1 - |cos|`` of a well-aligned normal keeps
that ulp while the term itself is small."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indoor_nerf_tpu.losses.priors as jp
import indoor_nerf_tpu_torch.losses.priors as tp
from _torch_parity import jax_prior_draws

torch.set_num_threads(1)
T = torch.from_numpy
CFG = tp.PriorConfig()
JCFG = jp.PriorConfig()
LOSS_RTOL = 1e-6
ULP = 2.0 ** -23


def assert_loss_close(got, want, weight, rtol=LOSS_RTOL, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ULP * weight,
                               err_msg=what)


def _rotation(rng):
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def manhattan_normals(rng, n_per_axis=60, noise=0.05, rot=None, scale=1.0):
    """Signed normals clustered on the axes of ``rot`` (the identity:
    aligned), with ``noise``, at magnitude ``scale`` (rendered normals are
    soft-normalised: below 1)."""
    rot = np.eye(3, dtype=np.float32) if rot is None else rot
    out = []
    for k in range(3):
        pts = rot[:, k][None] + noise * rng.standard_normal((n_per_axis, 3))
        out.append(pts * rng.choice([-1.0, 1.0], size=(n_per_axis, 1)))
    n = np.concatenate(out)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True) * scale
    return rng.permutation(n).astype(np.float32)


CASES = {
    "aligned": lambda rng: manhattan_normals(rng),
    "rotated": lambda rng: manhattan_normals(rng, rot=_rotation(rng)),
    "soft": lambda rng: manhattan_normals(rng, noise=0.3, scale=0.7),
    "random": lambda rng: rng.standard_normal((150, 3)).astype(np.float32),
    "one_direction": lambda rng: np.tile(np.float32([[0.1, 0.2, 0.9]]), (80, 1)),
    "few_confident": lambda rng: np.concatenate(
        [manhattan_normals(rng, 6), 0.1 * manhattan_normals(rng, 30)]),
    "few_normals": lambda rng: manhattan_normals(rng, 9),
    "weak": lambda rng: 0.05 * manhattan_normals(rng),
}


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("case", sorted(CASES))
def test_manhattan_frame_matches_jax(rng, case):
    """k-means from the same centers, then the polar factor: 1e-5, and the
    identity fallbacks (fewer than 20 confident, fewer than 30 normals)
    exactly."""
    normals = CASES[case](rng)
    conf = np.linalg.norm(normals, axis=-1)
    key = _jkey(3)
    want = np.asarray(jp.estimate_manhattan_frame(
        key, jnp.asarray(normals), jnp.asarray(conf), JCFG))
    centers = np.array(jax.random.normal(key, (3, 3)))
    got = tp.estimate_manhattan_frame(T(normals), T(conf), T(centers), CFG).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if case in ("few_confident", "few_normals", "weak"):
        np.testing.assert_array_equal(got, np.eye(3, dtype=np.float32))
    else:
        np.testing.assert_allclose(got.T @ got, np.eye(3), atol=1e-5)
        assert np.linalg.det(got) > 0


def test_frame_without_confidences_matches_jax(rng):
    normals = manhattan_normals(rng, rot=_rotation(rng))
    key = _jkey(8)
    want = np.asarray(jp.estimate_manhattan_frame(key, jnp.asarray(normals),
                                                  None, JCFG))
    got = tp.estimate_manhattan_frame(
        T(normals), None, T(np.array(jax.random.normal(key, (3, 3)))), CFG)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_polar_factor_is_the_svd_one(seed):
    """``u @ vt`` of numpy's SVD (in f64) for well and badly conditioned
    matrices, improper ones included; no gradient graph, no host sync."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 3))
    a = a @ np.diag([1.0, 10.0 ** -seed, 1.0]) @ _rotation(rng)
    u, _, vt = np.linalg.svd(a)
    got = tp.polar_factor(T(a.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, u @ vt, atol=1e-5)
    singular = tp.polar_factor(torch.zeros(3, 3))
    assert torch.isfinite(singular).all()


def _semantic_inputs(rng):
    """Normals with floor, wall and other rays, some unstable (|n| <= 0.1)."""
    n = manhattan_normals(rng, 40, noise=0.4, rot=_rotation(rng), scale=0.8)
    n[::7] *= 0.1
    return n


@pytest.mark.parametrize("case", ["mixed", "empty", "all_floor", "unstable"])
def test_detect_planes_matches_jax_exactly(rng, case):
    normals = {
        "mixed": lambda: _semantic_inputs(rng),
        "empty": lambda: np.zeros((50, 3), np.float32),
        "all_floor": lambda: np.tile(np.float32([[0.0, 0.1, -0.9]]), (40, 1)),
        "unstable": lambda: 0.05 * _semantic_inputs(rng)[:60],
    }[case]()
    depth = rng.uniform(2, 6, normals.shape[0]).astype(np.float32)
    want = jp.detect_planes(jnp.asarray(depth), jnp.asarray(normals), JCFG)
    got = tp.detect_planes(T(normals), CFG)
    for k in ("floor_mask", "wall_mask", "n_floor", "n_wall"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if case in ("empty", "unstable"):
        assert int(got["n_floor"]) == int(got["n_wall"]) == 0
    if case == "all_floor":
        assert int(got["n_floor"]) == 40 and int(got["n_wall"]) == 0


@pytest.mark.parametrize("case", ["walls", "empty"])
def test_cluster_wall_normals_matches_jax(rng, case):
    normals = _semantic_inputs(rng)
    mask = np.array(jp.detect_planes(None, jnp.asarray(normals), JCFG)["wall_mask"])
    if case == "empty":
        mask[:] = False
    else:
        assert mask.sum() > 10
    want = jp.cluster_wall_normals(jnp.asarray(normals[:, :2]), jnp.asarray(mask))
    got = tp.cluster_wall_normals(T(normals[:, :2]), T(mask))
    for k in ("wall_1", "wall_2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def _both_semantic(normals):
    want = jp.detect_planes(None, jnp.asarray(normals), JCFG)
    return want, {k: T(np.array(v)) for k, v in want.items()}


@pytest.mark.parametrize("case", ["rotated", "aligned", "empty"])
def test_manhattan_loss_matches_jax(rng, case):
    normals = (np.zeros((60, 3), np.float32) if case == "empty" else
               manhattan_normals(rng, noise=0.2, scale=0.9,
                                 rot=_rotation(rng) if case == "rotated" else None))
    frame = _rotation(rng) if case == "rotated" else np.eye(3, dtype=np.float32)
    jsem, tsem = _both_semantic(normals)
    w = np.float32(0.002)
    want = float(jp.manhattan_sdf_loss(jnp.asarray(normals), jnp.asarray(frame),
                                       jsem, jnp.asarray(w)))
    got = float(tp.manhattan_sdf_loss(T(normals), T(frame), tsem, T(np.asarray(w))))
    assert_loss_close(got, want, w)
    assert (want == 0.0) == (case == "empty")


@pytest.mark.parametrize("n", [5, 64, 300])
def test_planarity_loss_matches_jax(rng, n):
    """The same pairs (the JAX key's replayed); fewer than 10 rays: zero."""
    normals = _semantic_inputs(rng)[:n] if n <= 112 else np.concatenate(
        [_semantic_inputs(rng) for _ in range(3)])[:n]
    depth = rng.uniform(2, 6, n).astype(np.float32)
    jsem, tsem = _both_semantic(normals)
    key = _jkey(4)
    want = float(jp.structured_planarity_loss(key, jnp.asarray(depth), jsem,
                                              jnp.float32(0.005), JCFG))
    # The pairs the JAX function draws from the key it is given (:215-218).
    draws = {f"planar_{name}": T(np.asarray(jax.random.randint(
        k, (2, m), 0, n)).astype(np.int64)) for name, k, m in zip(
        ("floor", "wall", "other"), jax.random.split(key, 3), (100, 100, 50))}
    got = float(tp.structured_planarity_loss(T(depth), tsem, torch.tensor(0.005),
                                             draws))
    assert_loss_close(got, want, 0.005)
    assert (got == 0.0) == (n < 10)


@pytest.mark.parametrize("coords", [True, False])
@pytest.mark.parametrize("n", [6, 64, 257])
def test_consistency_loss_matches_jax(rng, coords, n):
    """With pixel coordinates (integers: neighbours tie at distance 1 and
    both sides pick the first) the nearest other ray, chosen exactly as
    JAX chooses it; without them the next ray."""
    normals = np.concatenate([_semantic_inputs(rng) for _ in range(3)])[:n]
    depth = rng.uniform(2, 6, n).astype(np.float32)
    sc = (rng.integers(0, 24, (n, 2)).astype(np.float32) if coords else None)
    key = _jkey(6)
    want = float(jp.spatial_normal_consistency_loss(
        key, jnp.asarray(normals), jnp.asarray(depth),
        None if sc is None else jnp.asarray(sc), jnp.float32(0.001), JCFG))
    hi = n if coords else n - 1
    m = tp.consistency_pairs(n, coords, CFG)
    idx1 = T(np.asarray(jax.random.randint(key, (m,), 0, hi)).astype(np.int64)) \
        if n >= 10 else None
    got = float(tp.spatial_normal_consistency_loss(
        T(normals), T(depth), None if sc is None else T(sc),
        torch.tensor(0.001), idx1))
    assert_loss_close(got, want, 0.001)
    assert (got == 0.0) == (n < 10)
    if coords and n >= 10:
        d = np.linalg.norm(sc[idx1.numpy()][:, None] - sc[None], axis=-1)
        d[np.arange(m), idx1.numpy()] = np.inf
        assert np.mean(np.sum(d == d.min(1, keepdims=True), 1) > 1) > 0.1


def _two_walls(rng, n=50):
    """Floor normals up and wall normals on +x and +y only (no sign flips):
    one most separated wall pair."""
    axes = np.float32([[0, 0, 1], [1, 0, 0], [0, 1, 0]])
    n = np.concatenate([a + 0.1 * rng.standard_normal((n, 3)) for a in axes])
    return rng.permutation(0.9 * n / np.linalg.norm(n, axis=-1, keepdims=True)
                           ).astype(np.float32)


@pytest.mark.parametrize("coords", [True, False])
@pytest.mark.parametrize("case", ["rotated", "random", "weak", "two_walls"])
def test_combine_structural_losses_matches_jax(rng, case, coords):
    """The whole combination with the JAX key's draws: counts exactly; each
    loss to 1e-4 relative, since here each side estimates its own frame
    (1e-6 apart), which moves ``1 - |cos|`` of well-aligned normals by that
    much relative to its small size. The wall angle to 1e-3 degrees where
    the most separated wall pair is one pair; where two pairs are equally
    separated to within f32 rounding (random normals), each side may split
    the walls by another pair and the angles differ: the test shows that
    tie (signed and random normals) instead of comparing them."""
    normals = {"rotated": lambda: manhattan_normals(
                   rng, 50, noise=0.15, rot=_rotation(rng), scale=0.9),
               "random": lambda: (0.5 * rng.standard_normal((150, 3))
                                  ).astype(np.float32),
               "weak": lambda: 0.05 * manhattan_normals(rng, 50),
               "two_walls": lambda: _two_walls(rng)}[case]()
    n = normals.shape[0]
    depth = rng.uniform(2, 6, n).astype(np.float32)
    sc = rng.integers(0, 32, (n, 2)).astype(np.float32) if coords else None
    weights = {"manhattan": 0.002, "planarity": 0.005, "normal_consistency": 0.001}
    key = _jkey(12)
    jtotal, jdiag = jp.combine_structural_losses(
        key, jnp.asarray(depth), jnp.asarray(normals),
        None if sc is None else jnp.asarray(sc),
        {k: jnp.float32(v) for k, v in weights.items()}, JCFG)
    draws = {k: T(v) for k, v in jax_prior_draws(key, n, coords, JCFG).items()}
    ttotal, tdiag = tp.combine_structural_losses(
        T(depth), T(normals), None if sc is None else T(sc),
        {k: torch.tensor(v) for k, v in weights.items()}, draws, CFG)
    for k in ("semantic_floor_count", "semantic_wall_count"):
        assert int(tdiag[k]) == int(jdiag[k]), k
    for k in ("manhattan", "planarity", "normal_consistency"):
        np.testing.assert_allclose(float(tdiag[k]), float(jdiag[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-4)
    ja, ta = float(jdiag["wall_cluster_angle_deg"]), float(tdiag["wall_cluster_angle_deg"])
    assert math.isnan(ja) == math.isnan(ta)
    if not math.isnan(ja):
        mask = np.asarray(jp.detect_planes(
            None, jnp.asarray(normals), JCFG)["wall_mask"])
        nd = normals[mask, :2].astype(np.float64)
        nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
        sims = np.sort((nd @ nd.T)[np.triu_indices(len(nd), 1)])
        if case == "two_walls":
            assert sims[1] - sims[0] > 1e-5
            np.testing.assert_allclose(ta, ja, atol=1e-3)
        else:  # signed or random normals: antiparallel pairs tie
            assert sims[1] - sims[0] <= 1e-5, (case, sims[:2])


def test_losses_carry_gradients_to_the_normals_and_depth(rng):
    normals = T(manhattan_normals(rng, 40, noise=0.2, scale=0.9)).requires_grad_(True)
    depth = T(rng.uniform(2, 6, 120).astype(np.float32)).requires_grad_(True)
    draws = tp.draw_priors(torch.Generator().manual_seed(0), 120, False)
    total, _ = tp.combine_structural_losses(
        depth, normals, None, {k: torch.tensor(1.0) for k in
                               ("manhattan", "planarity", "normal_consistency")},
        draws)
    gn, gd = torch.autograd.grad(total, (normals, depth))
    assert float(gn.abs().sum()) > 0 and float(gd.abs().sum()) > 0
    assert torch.isfinite(gn).all() and torch.isfinite(gd).all()


@pytest.mark.parametrize("n,coords", [(64, True), (64, False), (300, True), (8, True)])
def test_draws_have_the_jax_shapes_and_ranges(n, coords):
    draws = tp.draw_priors(torch.Generator().manual_seed(1), n, coords)
    want = jax_prior_draws(_jkey(0), n, coords, JCFG)
    assert sorted(draws) == sorted(want)
    for k, v in draws.items():
        assert tuple(v.shape) == want[k].shape, k
        if k != "centers":
            hi = n - 1 if (k == "consist_idx" and not coords) else n
            assert v.dtype == torch.int64 and 0 <= int(v.min()) and int(v.max()) < hi
