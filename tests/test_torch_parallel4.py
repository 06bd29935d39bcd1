"""Data parallelism of the port at W = 4 gloo ranks on the CPU, the layouts
that W = 2 does not reach (chap_tpu_torch/parallel/dist.py, pair-stream
units): the 2D CHAP step at batch 8 (s = 2, so U = 4 units, one a rank, and
each rank holds one stream only), the supervised 2D step, and the 3D CHAP
step at LA's layout (batch 4, s = 1, U = 2: ranks 0 and 2 hold no row and
still make every collective). Each against the one-process port on the
global batch at tests/test_torch_parallel.py's bars, and the 2D CHAP step
also against chap_tpu's step on a 4-device CPU mesh at
tests/test_torch_parallel_jax.py's.

One spawn of four ranks runs every case, while this process computes the
one-process results and chap_tpu's mesh step. The 3D step runs in float64,
as tests/test_torch_parallel.py's 3D cases do and for the same reason (in
float32 its argmax pseudo-labels amplify the ranks' other summation order).
"""
import concurrent.futures
import copy

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from chap_tpu_torch.config import Config
from chap_tpu_torch.models.factory import net_factory_3d
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.train.step_chap import draw_step_uniforms, level_channels
from test_torch_parallel import (B3, C3, LB3, NF, PATCH, float64, hold_steps,
                                 phantom_patches, step_cases)
from test_torch_parallel_jax import (chap_tpu_inputs, chap_tpu_mesh_step,
                                     hold_to_chap_tpu)

torch.set_num_threads(1)

W = 4
STEPS_3D = 2


def _cfg_la():
    """test_torch_step3d.py's CHAP config at LA's batch: 4 rows, 2 labeled."""
    cfg = Config()
    cfg.data.num_classes, cfg.data.batch_size = C3, B3
    cfg.data.labeled_bs = LB3
    cfg.data.patch_size_3d = PATCH
    cfg.model.n_filters_3d = NF
    cfg.semi.dropout = cfg.semi.adv_noise = True
    cfg.optim.remat = False
    cfg.optim.fused_passes = False
    return cfg


def _la_case():
    cfg = _cfg_la()
    torch.manual_seed(5)
    init = net_factory_3d("dualdecoder", 1, C3, cfg=cfg.model,
                          device="cpu").state_dict()
    sim = [torch.from_numpy(np.linspace(-0.5, 0.5, c).astype(np.float32))
           for c in level_channels(cfg, 3)]
    rs = np.random.RandomState(6)
    batches = [phantom_patches(rs, B3) for _ in range(STEPS_3D)]
    draws = [draw_step_uniforms(cfg, (B3, 1, *PATCH),
                                torch.Generator().manual_seed(20 + i))
             for i in range(STEPS_3D)]
    return ("chap3d_la", "run_steps", (cfg, float64(init), float64(sim),
                                       float64(batches), float64(draws),
                                       "chap3d"))


@pytest.fixture(scope="module")
def results():
    """(one-process results, the four ranks' results, chap_tpu's step on a
    4-device mesh)."""
    specs = [c for c in step_cases() if c[0] != "chap_remat"] + [_la_case()]
    built, jax_spec = chap_tpu_inputs()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(dist.spawn_ranks, cases.run_cases, W,
                        (specs + [jax_spec],), timeout=300)
    pool.shutdown(wait=False)
    one = cases.run_cases(copy.deepcopy(specs))
    return one, ranks.result(), chap_tpu_mesh_step(built, W)


def test_chap_steps_at_four_ranks_match_one_process(results):
    """Three CHAP steps at batch 8: one pair-stream unit a rank (rank r
    holds stream r % 2's pair r // 2, two rows), metrics, parameters, BN
    running statistics and GradSim scores."""
    one, ranks, _ = results
    assert [got["chap"]["rows"] for got in ranks] == [[2] * 3] * W
    hold_steps(one, ranks, "chap")


def test_supervised_steps_at_four_ranks_match_one_process(results):
    one, ranks, _ = results
    assert [got["supervised"]["rows"] for got in ranks] == [[2] * 3] * W
    hold_steps(one, ranks, "supervised")


def test_chap_3d_at_la_layout_with_two_empty_ranks(results):
    """The 3D CHAP step at batch 4 over four ranks: ranks 1 and 3 hold
    stream a's and stream b's pair, ranks 0 and 2 no row (BatchNorm, K1,
    K2, the means and the perturbation's rescale take count 0 there), and
    every rank makes the same collectives; two steps match one process."""
    one, ranks, _ = results
    assert [got["chap3d_la"]["rows"] for got in ranks] == [
        [0] * STEPS_3D, [2] * STEPS_3D, [0] * STEPS_3D, [2] * STEPS_3D]
    hold_steps(one, ranks, "chap3d_la")


def test_chap_step_at_four_ranks_matches_chap_tpu_on_a_four_device_mesh(results):
    _, ranks, want = results
    hold_to_chap_tpu(want, ranks)
