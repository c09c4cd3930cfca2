"""The port's file loaders, PNG reader, half-resolution resize and image ray
sampler against the JAX package's on fixtures these tests write.

Images, poses, render poses, hwf, K, splits, near/far, bbox and bds must be
identical; under ``--half_res`` the JAX loaders' ``cv2.resize(INTER_AREA)``
and the port's 2x2 mean agree within 1e-6.
"""

import sys

import imageio.v2 as imageio
import numpy as np
import pytest

from indoor_nerf_tpu.data import bbox as j_bbox
from indoor_nerf_tpu.data import poses as j_poses
from indoor_nerf_tpu.data.deepvoxels import load_dv_data as j_load_dv
from indoor_nerf_tpu.data.linemod import load_LINEMOD_data as j_load_linemod
from indoor_nerf_tpu.data.llff import load_llff_data as j_load_llff
from indoor_nerf_tpu.data.load import load_dataset as j_load_dataset
from indoor_nerf_tpu.data.pipeline import ImageRaySampler as JImageRaySampler
from indoor_nerf_tpu.data.scannet import load_scannet_data as j_load_scannet
from indoor_nerf_tpu.ops import rays as j_rays
from indoor_nerf_tpu.train.config import parse_args as j_parse_args
from indoor_nerf_tpu_torch.data import bbox, images, poses
from indoor_nerf_tpu_torch.data.blender import load_blender_data
from indoor_nerf_tpu_torch.data.deepvoxels import load_dv_data
from indoor_nerf_tpu_torch.data.linemod import load_LINEMOD_data
from indoor_nerf_tpu_torch.data.llff import load_llff_data
from indoor_nerf_tpu_torch.data.load import load_dataset
from indoor_nerf_tpu_torch.data.pipeline import ImageRaySampler
from indoor_nerf_tpu_torch.data.scannet import load_scannet_data
from indoor_nerf_tpu_torch.data.scene_files import make_plane_scene
from indoor_nerf_tpu_torch.ops import rays
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.utils.png import encode_png, read_png
from _torch_scenes import (
    random_image,
    write_blender,
    write_deepvoxels,
    write_linemod,
    write_llff,
    write_scannet,
)

CHANNELS = (1, 2, 3, 4)  # gray, gray+alpha, RGB, RGBA
FILTERS = (0, 1, 2, 3, 4, "mixed")  # None, Sub, Up, Average, Paeth, per row


def assert_same(got, want, what=""):
    """Equal values, types and dtypes, through tuples, lists and dicts."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("channels", CHANNELS)
def test_read_png_matches_imageio(tmp_path, channels, filt):
    rng = np.random.default_rng(channels)
    img = random_image(rng, 13, 17, channels)
    kind = [0, 1, 2, 3, 4, 4, 3, 1, 2, 0, 3, 4, 1] if filt == "mixed" else filt
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(encode_png(img, kind))
    want = imageio.imread(path)
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("channels", CHANNELS)
def test_read_png_reads_what_imageio_writes(tmp_path, channels):
    """A PNG of another encoder (imageio's, with its own row filters)."""
    img = random_image(np.random.default_rng(7), 31, 29, channels)
    img[:10] = 40  # flat rows, which an adaptive encoder filters otherwise
    path = str(tmp_path / "b.png")
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(read_png(path), imageio.imread(path))


def test_read_png_refuses_16_bit_and_names_the_file(tmp_path):
    path = str(tmp_path / "deep.png")
    imageio.imwrite(path, np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match=r"deep\.png.*bit depth 16"):
        read_png(path)


@pytest.mark.parametrize("channels", (3, 4))
def test_half_res_is_cv2_inter_area_at_even_sizes(channels):
    import cv2

    x = np.random.default_rng(1).random((3, 20, 26, channels), np.float32)
    want = np.stack([cv2.resize(i, (13, 10), interpolation=cv2.INTER_AREA)
                     for i in x])
    got = images.half_res(x)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_half_res_at_an_odd_size_takes_cv2_and_names_it(monkeypatch):
    import cv2

    x = np.random.default_rng(2).random((2, 21, 26, 3), np.float32)
    want = np.stack([cv2.resize(i, (13, 10), interpolation=cv2.INTER_AREA)
                     for i in x])
    np.testing.assert_array_equal(images.half_res(x), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="21x26.*'cv2'"):
        images.half_res(x)
    images.half_res(np.zeros((1, 4, 6, 3), np.float32))  # even: no cv2


def test_imread_of_other_files_names_imageio(tmp_path, monkeypatch):
    path = str(tmp_path / "IMG_0001.JPG")
    imageio.imwrite(path, np.full((8, 8, 3), 100, np.uint8))
    assert images.imread(path).shape == (8, 8, 3)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match=r"IMG_0001\.JPG.*'imageio'"):
        images.imread(path)


def test_numpy_helpers_are_the_jax_ones():
    assert_same(poses.spherical_render_poses(), j_poses.spherical_render_poses())
    assert_same(poses.spherical_render_poses(7, -10.0, 3.0),
                j_poses.spherical_render_poses(7, -10.0, 3.0))
    rng = np.random.default_rng(3)
    d = rays.get_ray_directions_np(6, 8, 7.5)
    assert_same(d, j_rays.get_ray_directions_np(6, 8, 7.5))
    c2w = rng.random((3, 4)).astype(np.float32)
    assert_same(rays.get_rays_from_directions_np(d, c2w),
                j_rays.get_rays_from_directions_np(d, c2w))
    o, v = rng.random((5, 3)) - [0, 0, 2], rng.random((5, 3)) - [0, 0, 1]
    assert_same(rays.get_ndc_rays_np(6, 8, 7.5, 1.0, o, v),
                j_rays.get_ndc_rays_np(6, 8, 7.5, 1.0, o, v))
    cams = {"camera_angle_x": 0.7, "frames": [
        {"transform_matrix": np.eye(4).tolist()},
        {"transform_matrix": rng.random((4, 4)).tolist()}]}
    assert_same(bbox.get_bbox3d_for_blenderobj(cams, 10, 12),
                j_bbox.get_bbox3d_for_blenderobj(cams, 10, 12))
    p = rng.random((3, 3, 4)).astype(np.float32) + [0, 0, 0, 0.5]
    assert_same(bbox.get_bbox3d_for_llff(p, [10, 12, 9.0]),
                j_bbox.get_bbox3d_for_llff(p, [10, 12, 9.0]))


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    """24 views of the sphere at 24x24 (12 train, 12 val and test)."""
    return write_blender(tmp_path_factory.mktemp("blender"))


@pytest.fixture(scope="module")
def llff_dir(tmp_path_factory):
    """The plane scene with its cameras turned by up to ~0.2 rad each
    (``--spherify`` needs optical axes that are not all parallel)."""
    c2ws = make_plane_scene(16)
    rng = np.random.default_rng(8)
    for c in c2ws:
        k = rng.normal(scale=0.1, size=3)
        q, r = np.linalg.qr(np.eye(3) + np.array(
            [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]))
        c[:, :3] = q * np.sign(np.diag(r))
    return write_llff(tmp_path_factory.mktemp("llff"), c2ws)


@pytest.fixture(scope="module")
def scannet_dir(tmp_path_factory):
    return write_scannet(tmp_path_factory.mktemp("scannet"))


@pytest.fixture(scope="module")
def linemod_dir(tmp_path_factory):
    return write_linemod(tmp_path_factory.mktemp("linemod"))


@pytest.fixture(scope="module")
def deepvoxels_dir(tmp_path_factory):
    return write_deepvoxels(tmp_path_factory.mktemp("dv"))


@pytest.mark.parametrize("half_res,testskip", [(False, 1), (True, 8),
                                               (True, 0)])
def test_blender_loader_is_the_jax_one(blender_dir, half_res, testskip):
    from indoor_nerf_tpu.data.blender import load_blender_data as j_load

    got = load_blender_data(blender_dir, half_res, testskip)
    want = j_load(blender_dir, half_res, testskip)
    if half_res:
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        got, want = got[1:], want[1:]
    assert_same(got, want)


def test_room_scene_in_blender_layout(tmp_path):
    """The Manhattan room of the structural priors written in blender
    layout: its views are the JAX package's room seen from the cameras'
    positions over ``ROOM_SCALE`` (the same directions), the JAX loader
    reads what the port's reads, and every surface a camera sees lies
    between the loader's fixed near and far (2, 6) along the camera axis."""
    from indoor_nerf_tpu.data.synthetic import _render_room as j_render_room
    from indoor_nerf_tpu_torch.data.scene_files import (
        ROOM_SCALE,
        make_room_blender_scene,
        write_blender_scene,
    )

    scene = make_room_blender_scene(8, 24, 24)
    depth = scene["depth"]
    assert 2.0 < float(depth.min()) and float(depth.max()) < 6.0
    H, W, focal = scene["hwf"]
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    ro, rd = rays.get_rays_np(H, W, K, scene["poses"][3][:3, :4])
    want = j_render_room(ro.reshape(-1, 3) / ROOM_SCALE, rd.reshape(-1, 3))
    np.testing.assert_array_equal(scene["images"][3, ..., :3].reshape(-1, 3), want)
    assert np.all(scene["images"][..., 3] == 1.0)
    write_blender_scene(str(tmp_path), scene)
    from indoor_nerf_tpu.data.blender import load_blender_data as j_load

    got = load_blender_data(str(tmp_path), False, 1)
    assert_same(got, j_load(str(tmp_path), False, 1))
    assert [len(i) for i in got[4]] == [6, 2, 2]


@pytest.mark.parametrize("jitter_test", [False, True])
def test_room_scene_exposure_jitter(jitter_test):
    """``make_room_blender_scene(exposure_jitter=0.25)``: the training
    views (with ``jitter_test`` the held-out ones too) are the clean views
    times their gain in U(0.75, 1.25), clipped to [0, 1]; the other views
    and the alpha stay clean, with gain 1; the gains repeat run to run."""
    from indoor_nerf_tpu_torch.data.scene_files import make_room_blender_scene
    from indoor_nerf_tpu_torch.data.synthetic import jitter_exposure

    clean = make_room_blender_scene(8, 12, 12)
    runs = [make_room_blender_scene(8, 12, 12, exposure_jitter=0.25,
                                    jitter_test=jitter_test)
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0]["images"], runs[1]["images"])
    np.testing.assert_array_equal(clean["exposure_gains"], np.ones(8))
    got, gains = runs[0]["images"], runs[0]["exposure_gains"]
    train, held = clean["i_split"][0], clean["i_split"][2]
    jittered = np.arange(8) if jitter_test else train
    assert gains.dtype == np.float32 and gains.shape == (8,)
    assert np.all((0.75 <= gains[jittered]) & (gains[jittered] <= 1.25))
    assert len(np.unique(gains[jittered])) == len(jittered)
    if not jitter_test:
        np.testing.assert_array_equal(gains[held], 1.0)
        np.testing.assert_array_equal(got[held], clean["images"][held])
    want = np.clip(clean["images"][..., :3]
                   * gains[:, None, None, None], 0.0, 1.0)
    np.testing.assert_array_equal(got[..., :3], want)
    np.testing.assert_array_equal(got[..., 3], 1.0)
    assert not np.array_equal(got[jittered], clean["images"][jittered])
    # The clip, on views bright enough to saturate; the alpha untouched.
    bright = np.full((8, 2, 2, 4), 0.95, np.float32)
    g = jitter_exposure(bright, np.arange(8), 0.25, np.random.default_rng(1))
    assert (g > 1 / 0.95).any() and (g < 1).any()
    np.testing.assert_array_equal(
        bright[..., :3], np.broadcast_to(np.minimum(
            np.float32(0.95) * g, 1.0)[:, None, None, None], (8, 2, 2, 3)))
    np.testing.assert_array_equal(bright[..., 3], np.float32(0.95))


@pytest.mark.parametrize("kw", [{}, {"spherify": True},
                                {"recenter": False, "bd_factor": None},
                                {"path_zflat": True}])
def test_llff_loader_is_the_jax_one(llff_dir, kw):
    assert_same(load_llff_data(llff_dir, 8, **kw), j_load_llff(llff_dir, 8, **kw))


def test_scannet_loader_is_the_jax_one(scannet_dir):
    got = load_scannet_data(scannet_dir, "scene0000_00")
    assert got[0].shape[0] == 3 + 2 + 2
    assert_same(got, j_load_scannet(scannet_dir, "scene0000_00"))
    got = load_scannet_data(scannet_dir, "scene0000_00", half_res=True)
    want = j_load_scannet(scannet_dir, "scene0000_00", half_res=True)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert_same(got[1:], want[1:])


def test_linemod_loader_is_the_jax_one(linemod_dir):
    assert_same(load_LINEMOD_data(linemod_dir, testskip=2),
                j_load_linemod(linemod_dir, testskip=2))


def test_deepvoxels_loader_is_the_jax_one(deepvoxels_dir):
    assert_same(load_dv_data("greek", deepvoxels_dir, 2),
                j_load_dv("greek", deepvoxels_dir, 2))


DATASETS = [
    ("blender", ["--white_bkgd"]),
    ("blender", ["--half_res", "--testskip", "1", "--render_test"]),
    ("llff", []),
    ("llff", ["--no_ndc", "--llffhold", "0", "--spherify"]),
    ("scannet", ["--half_res"]),
    ("LINEMOD", ["--white_bkgd", "--testskip", "2"]),
    ("deepvoxels", ["--shape", "greek", "--testskip", "2"]),
    ("synthetic", ["--render_test"]),
]


@pytest.mark.parametrize("dataset_type,flags", DATASETS)
def test_load_dataset_is_the_jax_one(dataset_type, flags, request):
    fixture = {"blender": "blender_dir", "llff": "llff_dir",
               "scannet": "scannet_dir", "LINEMOD": "linemod_dir",
               "deepvoxels": "deepvoxels_dir"}.get(dataset_type)
    argv = ["--dataset_type", dataset_type] + flags
    if fixture:
        argv += ["--datadir", request.getfixturevalue(fixture)]
    got, want = load_dataset(parse_args(argv)), j_load_dataset(j_parse_args(argv))
    half = "--half_res" in flags
    for field in ("images", "poses", "render_poses", "hwf", "K", "i_train",
                  "i_val", "i_test", "near", "far", "bounding_box", "ndc",
                  "bds"):
        g, w = getattr(got, field), getattr(want, field)
        if field == "images" and half:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            assert_same(g, w, field)
    assert got.images.shape[-1] == 3
    if dataset_type == "llff" and not flags:
        assert got.ndc and (got.near, got.far) == (0.0, 1.0)
    if "--render_test" in flags:
        np.testing.assert_array_equal(got.render_poses, got.poses[got.i_test])


def _samplers(n_rand=64, precrop_iters=500, seed=3):
    rng = np.random.default_rng(1)
    H, W = 20, 28
    imgs = rng.random((6, H, W, 3)).astype(np.float32)
    c2ws = rng.random((6, 4, 4)).astype(np.float32)
    K = np.array([[25.0, 0, W / 2], [0, 25.0, H / 2], [0, 0, 1]])
    args = (imgs, c2ws, np.array([0, 2, 3, 5]), H, W, K, n_rand)
    kw = dict(precrop_iters=precrop_iters, precrop_frac=0.5, seed=seed)
    return ImageRaySampler(*args, **kw), JImageRaySampler(*args, **kw)


def test_image_ray_sampler_is_the_jax_one_for_600_steps():
    """Bit for bit, across the precrop boundary at step 500."""
    got, want = _samplers()
    for step in range(1, 601):
        assert_same(got.next(step), want.next(step), f"step {step}")


def test_image_ray_sampler_skip_replays_the_draws():
    resumed, want = _samplers(precrop_iters=5)
    for step in range(1, 9):
        resumed.skip(step)
        want.next(step)
    for step in range(9, 12):
        assert_same(resumed.next(step), want.next(step), f"step {step}")
