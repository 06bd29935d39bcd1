"""Small sizes at which the benchmark's cells run on the CPU in the tests:
every width of the configuration cut, the pools and volumes a few items."""
import copy

ACDC = {"config": {"data": {"image_size": [32, 32], "batch_size": 4, "labeled_bs": 2},
                   "model": {"feature_chns": [4, 8, 8, 16, 16]}},
        "pool": {"items": 20, "labeled": 4}}
LA = {"config": {"data": {"patch_size_3d": [16, 16, 16]},
                 "model": {"n_filters_3d": 2, "dtype": "float32"},
                 "eval": {"sw_batch": 4}},
      "pool": {"items": 6, "labeled": 2, "extent": [20, 20, 18]},
      "traffic": {"volumes": 3, "extent": [24, 24, 20], "check_volumes": 2}}


def small(cell: str, **model) -> dict:
    """The overrides of ``cell`` at the small size; ``model`` replaces keys
    of its model config (``dtype="bfloat16"``: the configuration's own)."""
    out = copy.deepcopy(ACDC if cell.startswith("acdc") else LA)
    out["config"]["model"].update(model)
    return out
