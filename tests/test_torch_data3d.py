"""The port's 3D data path (transforms3d, Volume3dDataset, the device volume
pool and the on-device patch function with its rot / flip), held against
chap_tpu on the same numpy-seeded inputs (CPU)."""
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.data.device_data as jax_device_data
from chap_tpu.data.datasets import Volume3dDataset as JaxVolume3dDataset
from chap_tpu.data.transforms3d import RandomGenerator3D as JaxRandomGenerator3D
from chap_tpu_torch.data.datasets import Volume3dDataset
from chap_tpu_torch.data.device_data import (DeviceVolumePool,
                                             build_device_patch_fn,
                                             build_device_volume_pool,
                                             draw_augment_3d, gather_patches)
from chap_tpu_torch.data.transforms3d import RandomGenerator3D
from test_torch_models import JaxFeed

torch.set_num_threads(1)

PATCH = (8, 8, 6)


def _volumes(shapes, seed=0):
    rs = np.random.RandomState(seed)
    return [{"image": rs.rand(*s).astype(np.float32),
             "label": rs.randint(0, 3, s).astype(np.uint8)} for s in shapes]


@pytest.mark.parametrize("shape", [(14, 12, 9), (6, 10, 5)])
def test_random_generator_3d_equals_chap_tpu(shape):
    """Crop and rot / flip exactly chap_tpu's, with the channel axis first;
    (6, 10, 5) is smaller than the patch on two axes (centre padding)."""
    ours, theirs = RandomGenerator3D(PATCH, seed=4), JaxRandomGenerator3D(PATCH, seed=4)
    for sample in _volumes([shape] * 10, seed=1):     # both branches of the 50% draw
        a, b = ours(dict(sample)), theirs(dict(sample))
        assert a["image"].shape == (1, *PATCH) and a["label"].dtype == np.int32
        np.testing.assert_array_equal(a["image"][0], b["image"][..., 0])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_volume3d_dataset_reads_the_list_layout(tmp_path):
    """<root>/<list> names cases; each is <root>/data/<case>.h5 with 'image'
    and 'label' [X, Y, Z], read as chap_tpu reads it."""
    vols = _volumes([(6, 5, 4), (7, 5, 3)], seed=2)
    (tmp_path / "data").mkdir()
    for name, v in zip(("case_a", "case_b"), vols):
        with h5py.File(tmp_path / "data" / f"{name}.h5", "w") as f:
            f["image"], f["label"] = v["image"], v["label"]
    (tmp_path / "test.list").write_text("case_a\ncase_b,extra\n")
    ours, theirs = Volume3dDataset(str(tmp_path)), JaxVolume3dDataset(str(tmp_path))
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert a["case"] == b["case"] == ("case_a", "case_b")[i]
        for key in ("image", "label"):
            np.testing.assert_array_equal(a[key], b[key])


def test_volume_pool_equals_chap_tpu():
    """Centre-padded to the patch, then zero-padded into one common box, with
    the true extents kept."""
    vols = _volumes([(12, 9, 7), (5, 14, 6), (9, 9, 10)], seed=3)
    ours = build_device_volume_pool(vols, PATCH, torch.float32, device="cpu")
    theirs = jax_device_data.build_device_volume_pool(vols, PATCH, jnp.float32)
    assert ours.images.shape == (3, 12, 14, 10) and ours.labels.dtype == torch.uint8
    np.testing.assert_array_equal(ours.images.numpy(), np.asarray(theirs.images))
    np.testing.assert_array_equal(ours.labels.numpy(), np.asarray(theirs.labels))
    np.testing.assert_array_equal(ours.shapes.numpy(), np.asarray(theirs.shapes))


class _AugmentFeed:
    """``jax.random`` for chap_tpu's _augment_patch_3d with its draws fixed:
    uniform -> ``do`` (> 0.5 augments), randint -> k, then the flip axis."""

    split = staticmethod(jax.random.split)

    def __init__(self, do, k, ax):
        self.do, self.ints = do, [k, ax]

    def uniform(self, key, shape=()):
        return jnp.full(shape, 0.9 if self.do else 0.1, jnp.float32)

    def randint(self, key, shape, minval, maxval):
        return jnp.full(shape, self.ints.pop(0), jnp.int32)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("ax", [0, 1, 2, 3])
def test_patch_rot_flip_index_map_equals_chap_tpu(monkeypatch, k, ax):
    """Each (k, flip axis) of the on-card RandomRotFlip, ax 3 the identity
    branch, composed with the crop: exactly chap_tpu's _augment_patch_3d on
    the same crop, and numpy's flip(rot90(crop, k, axes=(0, 1)), ax)."""
    vols = _volumes([(11, 12, 9)], seed=5)
    pool = build_device_volume_pool(vols, PATCH, torch.float32, device="cpu")
    start = (2, 3, 1)
    imgs, labs = gather_patches(pool, torch.tensor([0]), torch.tensor([start]),
                                torch.tensor([k if ax < 3 else 0]), torch.tensor([ax]),
                                PATCH)
    sl = tuple(slice(s, s + p) for s, p in zip(start, PATCH))
    crop_i, crop_l = vols[0]["image"][sl], vols[0]["label"][sl]
    monkeypatch.setattr(jax_device_data, "jax", JaxFeed(
        _AugmentFeed(ax < 3, k, ax)))
    ji, jl = jax_device_data._augment_patch_3d(jnp.asarray(crop_i), jnp.asarray(crop_l),
                                               jax.random.PRNGKey(0))
    np.testing.assert_array_equal(imgs[0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(labs[0].numpy(), np.asarray(jl))
    want = np.rot90(crop_i, k if ax < 3 else 0, axes=(0, 1))
    np.testing.assert_array_equal(imgs[0].numpy(), want if ax == 3 else np.flip(want, ax))


def test_patch_fn_streams_and_crops_inside_true_extents():
    """Labeled rows from volumes [0, n_lab), unlabeled from the rest; with
    augment off every row is an exact crop of its volume lying inside its
    true extent (never the box's zero padding); uint8 labels, NCDHW."""
    shapes = [(9, 10, 8), (12, 8, 6), (8, 8, 11), (10, 13, 7), (8, 9, 6)]
    vols = []
    for v, s in enumerate(shapes):           # voxel value encodes (volume, x, y, z)
        x, y, z = np.meshgrid(*(np.arange(n) for n in s), indexing="ij")
        code = ((v + 1) * 1e6 + x * 1e4 + y * 1e2 + z).astype(np.float32)
        vols.append({"image": code, "label": (code % 3).astype(np.uint8)})
    pool = build_device_volume_pool(vols, PATCH, torch.float32, device="cpu")
    patch_fn = build_device_patch_fn(5, 2, 6, 3, PATCH, augment=False)
    gen = torch.Generator().manual_seed(3)
    for _ in range(5):
        batch = patch_fn(pool, gen)
        assert batch["image"].shape == (6, 1, *PATCH)
        assert batch["label"].shape == (6, *PATCH) and batch["label"].dtype == torch.uint8
        for row in range(6):
            img = batch["image"][row, 0].double().numpy()
            v = int(img[0, 0, 0] // 1e6) - 1
            assert (v < 2) == (row < 3), (row, v)
            corner = np.array([int(img[0, 0, 0] % 1e6 // 1e4),
                               int(img[0, 0, 0] % 1e4 // 1e2), int(img[0, 0, 0] % 1e2)])
            assert ((corner + PATCH) <= np.array(shapes[v])).all()
            sl = tuple(slice(c, c + p) for c, p in zip(corner, PATCH))
            np.testing.assert_array_equal(img, vols[v]["image"][sl])
    aug = build_device_patch_fn(5, 2, 6, 3, PATCH)
    b1, b2 = aug(pool, gen), aug(pool, gen)
    assert not torch.equal(b1["image"], b2["image"])
    with pytest.raises(ValueError, match="square"):
        build_device_patch_fn(5, 2, 6, 3, (8, 7, 6))(pool, gen)
    with pytest.raises(ValueError, match="num_labeled"):
        build_device_patch_fn(5, 5, 6, 3, PATCH)


def test_draw_augment_3d_follows_the_recipe():
    """Half the rows augmented, k over 0..3 and the flip axis over 0..2;
    the other half the identity (k 0, ax 3)."""
    k, ax = draw_augment_3d(4000, torch.Generator().manual_seed(0))
    ident = ax == 3
    assert abs(float(ident.float().mean()) - 0.5) < 0.03
    assert (k[ident] == 0).all()
    assert set(k[~ident].tolist()) == {0, 1, 2, 3} and set(ax[~ident].tolist()) == {0, 1, 2}


def test_pool_type_is_a_named_tuple():
    pool = build_device_volume_pool(_volumes([(8, 8, 6)]), PATCH, device="cpu")
    assert isinstance(pool, DeviceVolumePool) and pool.shapes.tolist() == [[8, 8, 6]]
