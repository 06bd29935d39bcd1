"""The port's semi-supervised primitives and K2's plain version, held
against chap_tpu on the same numpy-seeded inputs (CPU). K2's CUDA kernel
runs only on the card; chip_smoke.py holds it against this plain version
there, exactly, in the same three regimes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chap_tpu.semi.bcp import generate_mask_nd as jax_generate_mask_nd
from chap_tpu.semi.bcp import mix_images as jax_mix_images
from chap_tpu.semi.gradsim import ENCODER_LEVEL_PATHS as JAX_LEVEL_PATHS
from chap_tpu.semi.gradsim import update_grad_sim as jax_update_grad_sim
from chap_tpu.semi.nms import largest_cc_batch as jax_largest_cc_batch
from chap_tpu.semi.patchmask import create_mask_v1 as jax_create_mask_v1
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.semi import nms
from chap_tpu_torch.semi.bcp import generate_mask_nd, mix_images, patch_size_nd
from chap_tpu_torch.semi.gradsim import init_sim_scores, update_grad_sim
from chap_tpu_torch.semi.patchmask import create_mask_v1

torch.set_num_threads(1)


@pytest.mark.parametrize("hw,topk", [((32, 32), 0.1), ((30, 34), 0.25),
                                     ((16, 16), 0.5)])
def test_create_mask_v1_matches_chap_tpu(hw, topk):
    rs = np.random.RandomState(0)
    p1 = rs.randint(0, 3, (3, *hw))
    p2 = rs.randint(0, 3, (3, *hw))
    # quarter steps: every patch mean is exact in float32, so ties are real
    know = (rs.randint(0, 4, (3, *hw)) / 4.0).astype(np.float32)
    want = jax_create_mask_v1(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(know),
                              scale_factor=4, topk=topk)
    got = create_mask_v1(torch.from_numpy(p1), torch.from_numpy(p2),
                         torch.from_numpy(know), scale_factor=4, topk=topk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_mask_nd_with_chap_tpu_starts(seed):
    spatial = (32, 40)
    key = jax.random.PRNGKey(seed)
    want = jax_generate_mask_nd(key, spatial)
    # the box starts chap_tpu drew from this key
    starts = [int(jax.random.randint(k, (), 0, s - p))
              for k, s, p in zip(jax.random.split(key, 2), spatial,
                                 patch_size_nd(spatial))]
    got = generate_mask_nd(spatial, starts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rs = np.random.RandomState(seed)
    a, b = rs.rand(2, 1, *spatial).astype(np.float32), rs.rand(2, 1, *spatial).astype(np.float32)
    np.testing.assert_array_equal(
        mix_images(torch.from_numpy(a), torch.from_numpy(b), got).numpy(),
        np.transpose(np.asarray(jax_mix_images(
            jnp.asarray(a.transpose(0, 2, 3, 1)), jnp.asarray(b.transpose(0, 2, 3, 1)),
            want)), (0, 3, 1, 2)))


def test_update_grad_sim_matches_chap_tpu():
    rs = np.random.RandomState(3)
    chns = (4, 8, 16, 16, 32)
    ins = (1, 4, 8, 16, 16)
    torch_l = [rs.randn(o, i, 3, 3).astype(np.float32) for o, i in zip(chns, ins)]
    torch_u = [rs.randn(o, i, 3, 3).astype(np.float32) for o, i in zip(chns, ins)]
    old = [rs.rand(c).astype(np.float32) for c in chns]

    def tree(ws):   # Flax layout (kh, kw, I, O) at chap_tpu's level paths
        out = {}
        for path, w in zip(JAX_LEVEL_PATHS, ws):
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node["kernel"] = jnp.asarray(np.transpose(w, (2, 3, 1, 0)))
        return out

    want = jax_update_grad_sim(tuple(jnp.asarray(o) for o in old), tree(torch_l),
                               tree(torch_u), decay=0.81)
    got = update_grad_sim([torch.from_numpy(o) for o in old],
                          [torch.from_numpy(w) for w in torch_l],
                          [torch.from_numpy(w) for w in torch_u], decay=0.81)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert [int(s.numel()) for s in init_sim_scores(chns)] == list(chns)


def _regime(name, rs, b=4, hw=48, num_classes=4):
    """The three regimes of chap_tpu's NMS profile (nms.py:132-142)."""
    if name == "clean":
        return phantom_batch(rs, b, hw, num_classes)[1]
    if name == "speckled":
        lab = phantom_batch(rs, b, hw, num_classes)[1]
        noise = rs.rand(b, hw, hw) < 0.08
        lab[noise] = rs.randint(0, num_classes, int(noise.sum()))
        return lab
    # iid 30% fill per foreground class: percolating 8-connected clusters
    u = rs.rand(b, hw, hw)
    return np.select([u < 0.3, u < 0.6, u < 0.9], [1, 2, 3], 0).astype(np.int32)


@pytest.mark.parametrize("regime", ["speckled", "clean", "percolating"])
def test_k2_plain_matches_chap_tpu_exactly(regime):
    seg = _regime(regime, np.random.RandomState(11))
    want = np.asarray(jax_largest_cc_batch(jnp.asarray(seg), 4))
    got = nms.largest_cc_batch(torch.from_numpy(seg), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert nms.ccl_kernel.launches == 0     # the CPU never reaches K2


def test_largest_cc_mask_matches_chap_tpu():
    from chap_tpu.semi.nms import largest_cc_mask as jax_largest_cc_mask
    masks = _regime("percolating", np.random.RandomState(13)) == 2
    masks[0] = False                 # a mask with no foreground keeps nothing
    want = np.asarray(jax_largest_cc_mask(jnp.asarray(masks)))
    got = nms.largest_cc_mask(torch.from_numpy(masks))
    assert got.dtype == torch.bool and not got[0].any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_k2_ties_go_to_the_smallest_label():
    """Two equal components: the one with the smaller max-index label wins,
    where scipy's host path would pick by its own scan order."""
    seg = np.zeros((1, 8, 8), np.int32)
    seg[0, 0:2, 0:2] = 1      # label 9 (max linear index 1*8+1)
    seg[0, 5:7, 5:7] = 1      # label 54
    got = nms.largest_cc_batch(torch.from_numpy(seg), 2).numpy()
    want = np.asarray(jax_largest_cc_batch(jnp.asarray(seg), 2))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] == 1 and got[0, 5, 5] == 0


def test_k2_plain_agrees_with_host_oracle_on_clean_masks():
    seg = _regime("clean", np.random.RandomState(12))
    got = nms.largest_cc_batch(torch.from_numpy(seg), 4).numpy()
    np.testing.assert_array_equal(got, nms._largest_cc_host(seg, 4))


def test_k2_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        nms.ccl_kernel(torch.zeros(1, 4, 4, dtype=torch.int32), 4)


def _serpentine(h, w, stride=3):
    """One component that snakes through every row band: rows 0, stride,
    2 stride, ... are full and joined alternately at the right and left
    ends, so at 96^2 it crosses every 32x32 tile of the kernel."""
    m = np.zeros((h, w), np.int32)
    rows = list(range(0, h, stride))
    for i, y in enumerate(rows):
        m[y] = 1
        if i + 1 < len(rows):
            x = w - 1 if i % 2 == 0 else 0
            m[y:rows[i + 1] + 1, x] = 1
    return m


def _k2_case(name):
    if name == "serpentine":
        seg = np.zeros((2, 96, 96), np.int32)
        seg[0] = _serpentine(96, 96) * 2
        seg[1] = _serpentine(96, 96, 4) * 3
        seg[1, 50:60, 10:20] = 1
        return seg
    if name == "ties_across_tiles":          # equal 3x3 squares in 4 tiles
        seg = np.zeros((1, 96, 96), np.int32)
        for y, x in [(5, 5), (40, 70), (70, 10), (30, 31)]:
            seg[0, y:y + 3, x:x + 3] = 1
        seg[0, 80:82, 80:82] = 2
        seg[0, 10:12, 60:62] = 2
        return seg
    if name == "empty":
        return np.zeros((2, 40, 40), np.int32)
    return np.full((2, 40, 40), 2, np.int32)  # full foreground


@pytest.mark.parametrize("name", ["serpentine", "ties_across_tiles", "empty",
                                  "full"])
def test_k2_plain_matches_chap_tpu_on_tile_cases(name):
    """The cases that stress K2's tiles: one component through every tile,
    equal-size ties in different tiles, an empty and a full map."""
    seg = _k2_case(name)
    want = np.asarray(jax_largest_cc_batch(jnp.asarray(seg), 4))
    got = nms.largest_cc_batch(torch.from_numpy(seg), 4).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "serpentine":
        assert (got[0] == seg[0]).all()        # the snake is one component
    if name == "ties_across_tiles":
        assert got[0, 5, 5] == 1 and got[0, 40, 70] == 0 and got[0, 10, 60] == 2


# ---------------------------------------------------------------------------
# 3D: [B, X, Y, Z] maps, 26-connected (K2's 3D tiles are 8 x 16 x 16 voxels,
# 4 x 8 x 16 in its first version)
# ---------------------------------------------------------------------------

def _serpentine3d(nx, ny, nz):
    """One component through every 4x8x16 tile (K2 3D's first version; at
    16x40x48, through every 8x16x16 tile): a 2D serpentine in each even x
    plane, the planes joined at (y, z) = (0, 0)."""
    m = np.zeros((nx, ny, nz), np.int32)
    for x in range(0, nx, 2):
        m[x] = _serpentine(ny, nz, 3)
    m[:, 0, 0] = 1
    return m


def _diagonals(nx, ny, nz):
    """Voxel chains that touch only at corners (x, y, z all step) or along
    an edge (two of them step), across tile boundaries: the longest chain is
    the main diagonal; chains that step back in y or z follow the other
    backward neighbours; a 2-voxel chain joined only across a tile corner."""
    m = np.zeros((nx, ny, nz), np.int32)
    n = min(nx, ny, nz)
    for t in range(n):
        m[t, t, t] = 1                                   # corner steps
    for t in range(n - 4):
        m[t, ny - 1 - t, t + 2] = 1                      # y steps back
        m[t + 1, t, nz - 1 - t] = 1                      # z steps back
    for t in range(n - 6):
        m[t + 3, t, 0] = 1                               # edge steps (x, y)
        m[t, 0, t + 5] = 1                               # edge steps (x, z)
    m[3, 7, 15] = m[4, 8, 16] = 2                        # only across a corner
    m[7, 15, 3] = m[8, 16, 3] = 2                        # only across an edge
    return m


TILE_3D = (8, 16, 16)      # K2's 3D tile since it was redesigned


def _tile_contacts(tile=TILE_3D):
    """[7, 3 tx, 2.5 ty, 2.5 tz] maps whose components join only where two
    voxels meet across a tile corner or a tile edge, in each direction a
    cross-tile contact can take. Map 0: a class-1 chain of corner steps
    through a corner of eight tiles. Maps 1-6: a class-1 pair joined only
    across one tile edge (both voxels step across both boundaries, or one
    forward and one backward), beside a lone voxel with the smallest label:
    a pair left apart would tie with it and lose."""
    tx, ty, tz = tile
    m = np.zeros((7, 3 * tx, ty * 5 // 2, tz * 5 // 2), np.int32)
    for t in range(3 * tx):
        m[0, t, t + ty - tx, t + tz - tx] = 1            # (tx-1, ty-1, tz-1) -> +1
    pairs = [((tx - 1, ty - 1, 5), (tx, ty, 5)),          # x and y forward
             ((tx - 1, 3, tz - 1), (tx, 3, tz)),          # x and z forward
             ((3, ty - 1, tz - 1), (3, ty, tz)),          # y and z forward
             ((tx - 1, ty, 5), (tx, ty - 1, 5)),          # x forward, y back
             ((tx - 1, 5, tz), (tx, 5, tz - 1)),          # x forward, z back
             ((3, ty - 1, tz), (3, ty, tz - 1))]          # y forward, z back
    for i, (a, b) in enumerate(pairs, start=1):
        m[(i,) + a] = m[(i,) + b] = m[i, 0, 0, 0] = 1
    return m


def _combs(axis, tile=TILE_3D, n=32):
    """A 32^3 map with two class-1 combs whose teeth interleave (two voxels
    apart) across the face between two tiles along ``axis``: comb A has its
    spine below the face, comb B above it, so each crosses the face through
    8 teeth and each tile holds pieces of both. B is larger and alone is
    kept: pairing tile-local roots wrongly would merge the two, and a
    missed pair would cut teeth off B."""
    t = tile[axis]
    m = np.zeros((n, n, n), np.int32)
    b_ax, w_ax = [d for d in range(3) if d != axis]

    def put(a, b):
        idx = [0, 0, 0]
        idx[axis], idx[b_ax], idx[w_ax] = a, b, 4
        m[tuple(idx)] = 1
    for b in range(0, n, 4):
        for a in range(t - 6, t + 4):
            put(a, b)                                    # A's teeth
        for a in range(t - 4, t + 6):
            put(a, b + 2)                                # B's teeth
    for b in range(0, n - 3):
        put(t - 6, b)                                    # A's spine
    for b in range(2, n - 1):
        put(t + 5, b)                                    # B's spine, two thick
        put(t + 6, b)
    return m


def _k2_case_3d(name):
    rs = np.random.RandomState(21)
    if name == "ragged_23x29x17":
        return rs.randint(0, 3, (2, 23, 29, 17)), 3
    if name == "ragged_11x35x50":
        u = rs.rand(2, 11, 35, 50)
        return np.select([u < 0.15, u < 0.3], [1, 2], 0), 3
    if name == "serpentine_8x16x16":
        return _serpentine3d(16, 40, 48)[None], 2
    if name == "tile_contacts":
        return _tile_contacts(), 2
    if name == "interleaved_combs":
        return np.stack([_combs(a) for a in range(3)]), 2
    if name == "percolating_c3":
        u = rs.rand(2, 17, 33, 35)
        return np.select([u < 0.3, u < 0.6], [1, 2], 0), 3
    if name == "serpentine":
        return _serpentine3d(12, 24, 40)[None] * 2, 3
    if name == "diagonals":
        return _diagonals(20, 20, 20)[None], 3
    if name == "ties_across_tiles":
        seg = np.zeros((1, 12, 24, 40), np.int32)
        for x, y, z in [(0, 0, 0), (5, 10, 20), (9, 17, 35), (2, 12, 33)]:
            seg[0, x:x + 2, y:y + 2, z:z + 2] = 1      # equal cubes, four tiles
        seg[0, 8:10, 2:4, 2:3] = 2
        seg[0, 1:3, 20:22, 10:11] = 2
        return seg, 3
    if name == "percolating_c2":
        return (rs.rand(2, 9, 17, 20) < 0.3).astype(np.int32), 2
    if name == "all_foreground":
        return np.full((2, 5, 9, 17), 2, np.int32), 3
    return np.zeros((2, 5, 9, 17), np.int32), 2          # all background


K2_3D_CASES = ["ragged_23x29x17", "serpentine", "diagonals",
               "ties_across_tiles", "percolating_c2", "all_foreground",
               "all_background", "ragged_11x35x50", "serpentine_8x16x16",
               "tile_contacts", "interleaved_combs", "percolating_c3"]


@pytest.mark.parametrize("name", K2_3D_CASES)
def test_k2_plain_3d_matches_chap_tpu(name):
    """K2's 3D plain version (max_pool3d propagation) exactly equal to
    chap_tpu's largest_cc_batch on [B, X, Y, Z] maps: ragged maps (against
    the 4x8x16 and the 8x16x16 tile in every axis), serpentines through
    every tile, chains joined only through corners or edge diagonals,
    pairs joined only across an 8x16x16 tile's corner or edge, two combs
    interleaved across a tile face that must stay two components, ties
    across tiles, all foreground / background, percolating at C = 2 and
    3."""
    seg, c = _k2_case_3d(name)
    seg = np.asarray(seg, np.int32)
    want = np.asarray(jax_largest_cc_batch(jnp.asarray(seg), c))
    got = nms.largest_cc_batch(torch.from_numpy(seg), c)
    assert got.dtype == torch.int32 and got.shape == seg.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "serpentine":
        assert (got.numpy() == seg).all()               # one component
    if name == "diagonals":
        kept = got.numpy()[0]
        n = 20
        assert all(kept[t, t, t] == 1 for t in range(n))
        assert kept[3, 7, 15] == kept[4, 8, 16] == 2     # a corner joins them
    if name == "serpentine_8x16x16":
        assert (got.numpy() == seg).all()               # one component
    if name == "tile_contacts":
        want_kept = seg.copy()
        want_kept[1:, 0, 0, 0] = 0                      # the lone voxels lose
        np.testing.assert_array_equal(got.numpy(), want_kept)
    if name == "interleaved_combs":
        kept = got.numpy()
        assert all(kept[i].sum() == 130 for i in range(3))   # comb B alone
    assert nms.ccl3d_kernel.launches == 0


def test_k2_plain_3d_agrees_with_host_oracle():
    """26-connectivity: the plain version keeps what scipy's 26-connected
    labelling keeps, on maps without ties."""
    rs = np.random.RandomState(22)
    seg = np.zeros((2, 16, 16, 20), np.int32)
    for b in range(2):
        for k in range(3):
            lo = rs.randint(0, 10, 3)
            seg[b, lo[0]:lo[0] + 3 + k, lo[1]:lo[1] + 4, lo[2]:lo[2] + 2 + 2 * k] = 1
        seg[b, 15, 15, 19] = 2
    got = nms.largest_cc_batch(torch.from_numpy(seg), 3).numpy()
    np.testing.assert_array_equal(got, nms._largest_cc_host(seg, 3))


def test_k2_3d_dispatch_never_runs_the_plain_version_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to K2's 3D kernel wrapper, which
    launches or raises; the plain version runs for CPU tensors only."""
    def no_plain(*args):
        raise AssertionError("the plain version ran for a non-CPU tensor")
    monkeypatch.setattr(nms, "largest_cc_batch_plain", no_plain)
    monkeypatch.setattr(nms, "largest_cc_mask_plain", no_plain)
    meta = torch.zeros(2, 8, 8, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nms.largest_cc_batch(meta, 2)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nms.largest_cc_mask(meta.bool())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nms.ccl3d_kernel(torch.zeros(1, 4, 4, 4, dtype=torch.int32), 2)
    assert nms.ccl3d_kernel.launches == 0 and nms.ccl_kernel.launches == 0


@pytest.mark.parametrize("shape,topk", [((2, 32, 32, 16), 0.1),
                                        ((2, 30, 34, 18), 0.25),
                                        ((3, 16, 16, 16), 0.5)])
def test_create_mask_v1_3d_matches_chap_tpu(shape, topk):
    """The 3D patch grid, with a remainder along every axis at 30x34x18:
    exact (quarter-step scores make ties real)."""
    rs = np.random.RandomState(1)
    p1 = rs.randint(0, 2, shape)
    p2 = rs.randint(0, 2, shape)
    know = (rs.randint(0, 4, shape) / 4.0).astype(np.float32)
    want = jax_create_mask_v1(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(know),
                              scale_factor=4, topk=topk)
    got = create_mask_v1(torch.from_numpy(p1), torch.from_numpy(p2),
                         torch.from_numpy(know), scale_factor=4, topk=topk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vnet_level_paths_name_the_encoder_level_convs():
    """VNET_LEVEL_PATHS are the port's module paths of chap_tpu's
    VNET_LEVEL_PATHS: the last conv of each encoder scale, widths nf x (1, 2,
    4, 8, 16)."""
    from chap_tpu.semi.gradsim import VNET_LEVEL_PATHS as JAX_VNET_PATHS
    from chap_tpu_torch.config import ModelConfig
    from chap_tpu_torch.convert.from_jax import dualdecoder3d_rules
    from chap_tpu_torch.models.factory import net_factory_3d
    from chap_tpu_torch.semi.gradsim import VNET_LEVEL_PATHS
    cfg = ModelConfig()
    cfg.n_filters_3d = 2
    params = dict(net_factory_3d("dualdecoder", 1, 2, "train", cfg,
                                 device="cpu").named_parameters())
    flax_of = {f"{tp}.weight": fp for tp, _, fp in dualdecoder3d_rules()}
    for path, jax_path, width in zip(VNET_LEVEL_PATHS, JAX_VNET_PATHS,
                                     (2, 4, 8, 16, 32)):
        assert params[path].shape[0] == width
        assert flax_of[path] == "/".join(jax_path)
