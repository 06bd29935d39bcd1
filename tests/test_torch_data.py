"""The port's data path (datasets, transforms, sampler, host loader, device
pool and on-device augmentation) and its host metrics, held against chap_tpu
on the same numpy-seeded inputs (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import rotate

import chap_tpu.data.datasets as jax_datasets
import chap_tpu.metrics.surface as jax_surface
from chap_tpu.data.device_data import apply_augment as jax_apply_augment
from chap_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from chap_tpu.data.sampler import TwoStreamBatchSampler as JaxSampler
from chap_tpu.data.transforms import RandomGenerator as JaxRandomGenerator
from chap_tpu.metrics.dice import hard_dice as jax_hard_dice
from chap_tpu.metrics.dice import soft_dice as jax_soft_dice
from chap_tpu_torch.config import DataConfig
from chap_tpu_torch.data import datasets
from chap_tpu_torch.data.device_data import (DevicePool, apply_augment,
                                             build_device_batch_fn,
                                             build_device_pool, draw_augment)
from chap_tpu_torch.data.pipeline import (BatchLoader, compact_batch,
                                          prefetch_to_device)
from chap_tpu_torch.data.sampler import TwoStreamBatchSampler
from chap_tpu_torch.data.transforms import RandomGenerator
from chap_tpu_torch.metrics import surface
from chap_tpu_torch.metrics.dice import hard_dice, soft_dice

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# sampler, transforms, datasets: exactly chap_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_lab,n_all,bs,sec,seed", [
    (20, 100, 8, 4, 0), (68, 80, 8, 4, 1337), (136, 1312, 24, 12, 5)])
def test_sampler_equals_chap_tpu_over_three_epochs(n_lab, n_all, bs, sec, seed):
    ours = TwoStreamBatchSampler(range(n_lab), range(n_lab, n_all), bs, sec, seed)
    theirs = JaxSampler(range(n_lab), range(n_lab, n_all), bs, sec, seed)
    assert len(ours) == len(theirs)
    for _ in range(3):
        assert list(ours) == list(theirs)


def test_sampler_refuses_too_few_slices():
    with pytest.raises(ValueError, match="labeled"):
        TwoStreamBatchSampler(range(3), range(3, 20), 8, 4)
    with pytest.raises(ValueError, match="UNlabeled"):
        TwoStreamBatchSampler(range(10), range(10, 12), 8, 4)


@pytest.mark.parametrize("in_hw,out_hw", [((100, 90), (64, 64)), ((48, 48), (48, 48))])
def test_random_generator_equals_chap_tpu(in_hw, out_hw):
    ours, theirs = RandomGenerator(out_hw, seed=3), JaxRandomGenerator(out_hw, seed=3)
    rs = np.random.RandomState(0)
    for _ in range(12):      # enough draws to take every branch
        sample = {"image": rs.rand(*in_hw).astype(np.float32),
                  "label": rs.randint(0, 4, in_hw)}
        a, b = ours(dict(sample)), theirs(dict(sample))
        for key in ("image", "label"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("hard", [False, True])
def test_synthetic_datasets_equal_chap_tpu(hard):
    ours = datasets.SyntheticSliceDataset(48, 4, 6, seed=2, hard=hard)
    theirs = jax_datasets.SyntheticSliceDataset(48, 4, 6, seed=2, hard=hard)
    for i in (0, 3, 5):
        for key in ("image", "label"):
            np.testing.assert_array_equal(ours[i][key], theirs[i][key])
    ours_v = datasets.SyntheticVolumeDataset((3, 32, 32), 4, 2, hard=hard)
    theirs_v = jax_datasets.SyntheticVolumeDataset((3, 32, 32), 4, 2, hard=hard)
    assert len(ours_v) == len(theirs_v) == 2
    for key in ("image", "label", "case"):
        np.testing.assert_array_equal(ours_v[1][key], theirs_v[1][key])


def test_build_datasets_and_patients_table_equal_chap_tpu():
    cfg = DataConfig(dataset="synthetic_hard", image_size=(32, 32),
                     synthetic_train_size=20, synthetic_val_volumes=2)
    train, val = datasets.build_datasets(cfg)
    j_train, j_val = jax_datasets.build_datasets(cfg)
    assert (len(train), len(val)) == (len(j_train), len(j_val)) == (20, 2)
    np.testing.assert_array_equal(train[7]["image"], j_train[7]["image"])
    np.testing.assert_array_equal(val[1]["label"], j_val[1]["label"])
    for name, n in (("ACDC", 7), ("synthetic", 3), ("Prostate", 8)):
        assert datasets.patients_to_slices(name, n) == \
            jax_datasets.patients_to_slices(name, n)


def test_acdc_h5_datasets_read_the_list_layout(tmp_path):
    h5py = pytest.importorskip("h5py")
    rs = np.random.RandomState(0)
    (tmp_path / "data" / "slices").mkdir(parents=True)
    (tmp_path / "train_slices.list").write_text("p1_s0\np1_s1\n")
    (tmp_path / "val.list").write_text("p1\n")
    vol = {"image": rs.rand(2, 16, 16).astype(np.float32),
           "label": rs.randint(0, 4, (2, 16, 16)).astype(np.uint8)}
    with h5py.File(tmp_path / "data" / "p1.h5", "w") as f:
        for k, v in vol.items():
            f[k] = v
    for s in range(2):
        with h5py.File(tmp_path / "data" / "slices" / f"p1_s{s}.h5", "w") as f:
            for k, v in vol.items():
                f[k] = v[s]
    train = datasets.AcdcSliceDataset(str(tmp_path))
    val = datasets.AcdcVolumeDataset(str(tmp_path), "val")
    assert len(train) == 2 and len(val) == 1
    np.testing.assert_array_equal(train[1]["label"], vol["label"][1])
    assert val[0]["case"] == "p1"
    np.testing.assert_array_equal(val[0]["image"], vol["image"])


# ---------------------------------------------------------------------------
# host loader
# ---------------------------------------------------------------------------

def test_batch_loader_equals_chap_tpu_in_nchw():
    """Same sampler order and the same RandomGenerator draws (one worker,
    so the shared transform sees the samples in order)."""
    def loader(cls, sampler_cls, transform_cls):
        ds = datasets.SyntheticSliceDataset(
            32, 4, 40, transform=transform_cls((32, 32), seed=1))
        return cls(ds, sampler_cls(range(16), range(16, 40), 8, 4, seed=2),
                   num_workers=1)
    ours = list(loader(BatchLoader, TwoStreamBatchSampler, RandomGenerator))
    theirs = list(loader(JaxBatchLoader, JaxSampler, JaxRandomGenerator))
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a["image"].shape == (8, 1, 32, 32)
        np.testing.assert_array_equal(a["image"], b["image"].transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(a["label"], b["label"])


def test_batch_loader_propagates_worker_failure():
    class Corrupt:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            if i == 9:
                raise OSError("corrupt h5 block")
            return {"image": np.zeros((8, 8), np.float32),
                    "label": np.zeros((8, 8), np.int64)}

    loader = BatchLoader(Corrupt(), [[0, 1], [2, 3], [8, 9], [10, 11]],
                         num_workers=2)
    with pytest.raises(RuntimeError, match="worker failed"):
        list(loader)


def test_compact_batch_and_prefetch_on_the_cpu():
    rs = np.random.RandomState(0)
    batches = [{"image": rs.rand(4, 1, 8, 8), "label": rs.randint(0, 4, (4, 8, 8))}
               for _ in range(3)]
    out = list(prefetch_to_device(iter(batches), "cpu", size=2,
                                  transform=compact_batch))
    assert len(out) == 3
    for got, want in zip(out, batches):
        assert got["image"].dtype == torch.float32 and got["label"].dtype == torch.uint8
        np.testing.assert_array_equal(got["image"].numpy(), want["image"].astype(np.float32))
        np.testing.assert_array_equal(got["label"].numpy(), want["label"])


# ---------------------------------------------------------------------------
# device pool and on-device augmentation
# ---------------------------------------------------------------------------

def _rand_img(h=32, w=32, seed=0, n=1):
    r = np.random.RandomState(seed)
    return (r.rand(n, h, w).astype(np.float32),
            r.randint(0, 4, (n, h, w)).astype(np.uint8))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("ax", [0, 1])
def test_rot_flip_exact(k, ax):
    img, lab = _rand_img()
    oi, ol = apply_augment(torch.from_numpy(img), torch.from_numpy(lab), 0, k, ax, 0.0)
    ji, jl = jax_apply_augment(jnp.asarray(img[0]), jnp.asarray(lab[0]), 0, k, ax, 0.0)
    np.testing.assert_array_equal(oi[0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ol[0].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(oi[0].numpy(), np.flip(np.rot90(img[0], k), ax))
    np.testing.assert_array_equal(ol[0].numpy(), np.flip(np.rot90(lab[0], k), ax))


@pytest.mark.parametrize("deg", [-19, -7, 5, 19])
def test_rotation_matches_chap_tpu_and_scipy(deg):
    """Mode 1 against chap_tpu's gather and scipy.ndimage.rotate(order=0,
    reshape=False): the same inverse map, so agreement is exact up to
    float32 coordinate rounding on a thin boundary set (>= 99.9%)."""
    img, lab = _rand_img(48, 48, seed=3)
    ang = np.float32(np.deg2rad(deg))
    oi, ol = apply_augment(torch.from_numpy(img), torch.from_numpy(lab), 1, 0, 0, ang)
    ji, jl = jax_apply_augment(jnp.asarray(img[0]), jnp.asarray(lab[0]), 1, 0, 0,
                               jnp.float32(ang))
    for got, want in ((oi[0].numpy(), np.asarray(ji)), (ol[0].numpy(), np.asarray(jl)),
                      (oi[0].numpy(), rotate(img[0], deg, order=0, reshape=False,
                                             mode="constant"))):
        agree = float(np.mean(got == want))
        assert agree >= 0.999, f"pixel agreement {agree:.5f}"


def test_identity_mode_and_mixed_batch():
    """Per-sample parameters in one batch: each row equals its own
    chap_tpu call (rows in modes 0 and 2 exactly; mode 1 here at 0 degrees,
    also exact)."""
    img, lab = _rand_img(24, 24, seed=1, n=4)
    mode, k, ax = [0, 2, 1, 0], [3, 1, 0, 2], [1, 0, 1, 0]
    ang = [0.0, 0.5, 0.0, 0.3]
    oi, ol = apply_augment(torch.from_numpy(img), torch.from_numpy(lab),
                           torch.tensor(mode), torch.tensor(k), torch.tensor(ax),
                           torch.tensor(ang))
    for r in range(4):
        ji, jl = jax_apply_augment(jnp.asarray(img[r]), jnp.asarray(lab[r]),
                                   mode[r], k[r], ax[r], jnp.float32(ang[r]))
        np.testing.assert_array_equal(oi[r].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ol[r].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(oi[1].numpy(), img[1])


def test_draw_augment_follows_the_recipe():
    mode, k, ax, ang = draw_augment(4000, torch.Generator().manual_seed(0))
    share = [float((mode == m).float().mean()) for m in range(3)]
    np.testing.assert_allclose(share, [0.5, 0.25, 0.25], atol=0.03)
    assert set(k.tolist()) == {0, 1, 2, 3} and set(ax.tolist()) == {0, 1}
    deg = torch.round(ang * 180 / np.pi)
    assert deg.min() == -20 and deg.max() == 19


def test_batch_fn_layout_and_streams():
    """Labeled rows from [0, n_lab), unlabeled rows from [n_lab, N), each an
    exact pool row with augment off; labels uint8, images NCHW."""
    n, h, w = 20, 16, 16
    r = np.random.RandomState(0)
    images = np.arange(n, dtype=np.float32)[:, None, None] * np.ones((n, h, w), np.float32)
    labels = r.randint(0, 4, (n, h, w)).astype(np.uint8)
    pool = DevicePool(torch.from_numpy(images), torch.from_numpy(labels))
    batch_fn = build_device_batch_fn(n, 6, batch_size=8, labeled_bs=4, augment=False)
    batch = batch_fn(pool, torch.Generator().manual_seed(7))
    assert batch["image"].shape == (8, 1, h, w)
    assert batch["label"].shape == (8, h, w) and batch["label"].dtype == torch.uint8
    ids = batch["image"][:, 0, 0, 0].long().tolist()
    assert all(0 <= i < 6 for i in ids[:4]) and all(6 <= i < n for i in ids[4:]), ids
    for row, i in enumerate(ids):
        np.testing.assert_array_equal(batch["label"][row].numpy(), labels[i])
    aug = build_device_batch_fn(n, 6, batch_size=8, labeled_bs=4)
    gen = torch.Generator().manual_seed(1)
    b1, b2 = aug(pool, gen), aug(pool, gen)
    assert not torch.equal(b1["image"], b2["image"])
    with pytest.raises(ValueError, match="square"):
        aug(DevicePool(pool.images[:, :, :8], pool.labels[:, :, :8]), gen)


def test_build_pool_resizes_and_strips_transform():
    class Ds:
        transform = object()

        def __len__(self):
            return 3

        def __getitem__(self, i):
            assert self.transform is None, "pool build must bypass transform"
            r = np.random.RandomState(i)
            return {"image": r.rand(20, 24).astype(np.float32),
                    "label": r.randint(0, 3, (20, 24))}

    ds = Ds()
    saved = ds.transform
    pool = build_device_pool(ds, (16, 16), torch.float32, device="cpu")
    assert pool.images.shape == pool.labels.shape == (3, 16, 16)
    assert pool.labels.dtype == torch.uint8 and ds.transform is saved


# ---------------------------------------------------------------------------
# host metrics (medpy-exact) and device dice
# ---------------------------------------------------------------------------

def _mask_pairs():
    rs = np.random.RandomState(0)
    square = np.zeros((64, 64), bool)
    square[10:30, 10:30] = True
    vol = rs.rand(6, 40, 40) > 0.6
    return [(square, np.roll(square, 3, axis=1)),
            (rs.rand(48, 48) > 0.7, rs.rand(48, 48) > 0.5),
            (vol, np.roll(vol, 2, axis=0)),
            (square, square)]


@pytest.mark.parametrize("pair", range(4))
def test_surface_metrics_equal_chap_tpu(pair):
    a, b = _mask_pairs()[pair]
    for name in ("dc", "jc", "ravd", "hd", "hd95", "asd", "assd"):
        assert getattr(surface, name)(a, b) == getattr(jax_surface, name)(a, b), name
    for name in ("calculate_metric_percase", "calculate_metric_percase_full"):
        assert getattr(surface, name)(a, b) == getattr(jax_surface, name)(a, b)
    for name in ("cal_metric_3d", "cal_metric_3d_full"):
        np.testing.assert_array_equal(getattr(surface, name)(b, a),
                                      getattr(jax_surface, name)(b, a))
    empty = np.zeros_like(a)
    assert surface.calculate_metric_percase(empty, b) == (0.0, 0.0)


def test_device_dice_matches_chap_tpu():
    rs = np.random.RandomState(0)
    probs = rs.dirichlet(np.ones(4), size=(2, 8, 8)).astype(np.float32)  # NHWC
    onehot = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (2, 8, 8))]
    got = soft_dice(torch.from_numpy(probs.transpose(0, 3, 1, 2)),
                    torch.from_numpy(onehot.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(float(got), float(jax_soft_dice(probs, onehot)),
                               rtol=1e-6)
    pred, gt = rs.randint(0, 3, (2, 8, 8)), rs.randint(0, 3, (2, 8, 8))
    np.testing.assert_allclose(hard_dice(torch.from_numpy(pred), torch.from_numpy(gt), 3).numpy(),
                               np.asarray(jax_hard_dice(pred, gt, 3)), rtol=1e-6)
