"""Time the single-decoder supervised step of 2D zoo keys and one forward +
backward of the three transformer decoders, in whichever ``chap_tpu_torch``
is first on the import path, on one CUDA card.

It holds two trees of the port against each other on one card: run it
once per tree with ``PYTHONPATH`` set to that tree's root, all in one
command, in the order A B B A, and compare the medians of each pair.

    PYTHONPATH=<tree> python3 tools/time_paths.py --tag A \\
        --dtypes float32 bfloat16 --out build/time_paths.jsonl

Shapes are chip_smoke.py's phases 24 (b) and 25 (b): configs/acdc_chap.yml's
widths at 24 x 256^2 (swinunet at its factory's 224^2), phantom batches,
random weights from a seed; the decoders on resnet50's pyramid of a 24 x 3
x 256^2 batch. Each figure is the median wall time of ``--steps`` calls,
synchronised after each, after ``--warmup`` calls. PyTorch's TF32 defaults
are kept. Prints one JSON line (also appended to ``--out``) and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from chap_tpu_torch.config import acdc_chap_config
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.models import resnet
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.layers import set_compute_dtype
from chap_tpu_torch.models.transformer_decoder import (KMaxTransformerDecoder,
                                                       MaskTransformerDecoder,
                                                       MaskTransformerDecoderV1)
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.train.step_supervised import build_supervised_train_step

KEYS = ("swinunet", "enet")


def timed_ms(fn, warmup: int, steps: int) -> list:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def flat(out) -> list:
    """The tensors of a nest of lists and tuples."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat(o)]
    return [out]


def step_times(key: str, dtype: str, warmup: int, steps: int) -> list:
    """ms of the single-decoder supervised step of ``key`` in ``dtype``."""
    cfg = acdc_chap_config()
    cfg.model.name, cfg.model.dtype = key, dtype
    if key == "swinunet":
        cfg.data.image_size = (224, 224)
    batches = []
    for seed in range(4):
        images, labels = phantom_batch(np.random.RandomState(60 + seed),
                                       cfg.data.batch_size, cfg.data.image_size[0],
                                       cfg.data.num_classes)
        batches.append({"image": torch.from_numpy(images).cuda().to(getattr(torch, dtype)),
                        "label": torch.from_numpy(labels).cuda()})
    torch.manual_seed(1337)
    model = net_factory(key, 1, 4, cfg.model, device="cuda")
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    state = create_train_state(model, opt)
    step = build_supervised_train_step(model, opt, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1337)
    calls = iter(range(10 ** 9))
    return timed_ms(lambda: step(state, batches[next(calls) % 4], gen),
                    warmup, steps)


def decoder_times(dtype: torch.dtype, warmup: int, steps: int) -> dict:
    """ms of one forward + backward of each decoder in train mode."""
    gen = torch.Generator(device="cuda").manual_seed(53)
    img = torch.randn((24, 3, 256, 256), generator=gen, device="cuda")
    torch.manual_seed(54)
    with torch.no_grad():
        pyramid = resnet.resnet50(in_chns=3).cuda().eval()(img)
    levels = [f.to(dtype) for f in pyramid[:0:-1]]          # c5, c4, c3, c2
    chans = [f.shape[1] for f in levels]
    makers = {
        "mask_decoder": (lambda: MaskTransformerDecoder(chans), (levels,)),
        "mask_decoder_v1": (lambda: MaskTransformerDecoderV1(chans, pyramid[0].shape[1]),
                            (levels, pyramid[0].to(dtype))),
        "kmax_decoder": (lambda: KMaxTransformerDecoder(chans), (levels,)),
    }
    out = {}
    for name, (make, args) in makers.items():
        torch.manual_seed(54)
        model = set_compute_dtype(make().cuda().train(), dtype)

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            sum(t.float().mean() for t in flat(model(*args))).backward()

        out[name] = timed_ms(fwd_bwd, warmup, steps)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True, help="name of the tree measured")
    ap.add_argument("--dtypes", nargs="+", default=["float32"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--out", default=None, help="a JSON-lines file to append to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_paths.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    res = {"tag": args.tag, "card": card, "torch": torch.__version__}
    for dtype in args.dtypes:
        row = {f"step_{k}": step_times(k, dtype, args.warmup, args.steps) for k in KEYS}
        torch.cuda.empty_cache()
        row.update({f"fwd_bwd_{k}": v for k, v in decoder_times(
            getattr(torch, dtype), args.warmup, args.steps).items()})
        torch.cuda.empty_cache()
        res[dtype] = {k: {"median_ms": statistics.median(v), "ms": v}
                      for k, v in row.items()}
    line = json.dumps(res)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
