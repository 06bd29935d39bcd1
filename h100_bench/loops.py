"""The one general generator: it reads a configuration's file
(configs/<config>.json) and a traffic mix (traffic/<mix>.json) and drives
the program through one of two loops, named by the mix's ``loop``:

``train``
    The 2D or 3D trainer's loop between evals: each step is the device
    batch function over the pool, then the ``mode`` step (``chap`` or
    ``supervised``) called as the trainer calls it, with the trainer's one
    device->host copy of the metrics every ``log_every`` steps. A closed
    loop: the next step is enqueued when the host returns from this one.
``sliding_window_eval``
    ``cli.test_3d``'s ``test_all_case`` without the host's surface metrics:
    the sliding-window engine driven ``depth`` deep over ``volumes`` phantom
    volumes of ``extent``, volume i + 1 enqueued before volume i's label
    map is finalised (with the host largest-CC when ``nms``).

A cell is built in ``setup`` (pool, weights, the checked first steps or
nothing, warm-up), measured in ``window``, optionally profiled in
``stretch``, and judged in ``check`` against the plain reference once the
program's state is freed.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import data
from h100_bench.check import label_share, pseudo_moved, train_numbers
from h100_bench.counts import kernel_bytes, peaks
from h100_bench.trace import Stretch, profile_stretch, span

# the streams of draws of a run (data.sub_seed tags)
POOL, WEIGHTS, BATCHES, CHECK_DRAWS, STEP_DRAWS, ORDER = range(6)


def port_config(values: dict):
    from chap_tpu_torch.config import Config, update_values
    return update_values(values, Config())


def ref_config(values: dict):
    from h100_bench.reference.config import Config, update_values
    return update_values(values, Config())


def tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counted(fn: Callable[[], object], count: bool) -> Tuple[object, Optional[int]]:
    """(fn(), its FLOPs as torch's FlopCounterMode counts them, or None)."""
    if not count:
        return fn(), None
    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, int(counter.get_total_flops())


@contextlib.contextmanager
def pseudo_labels(out: List[torch.Tensor], on: bool):
    """While open (and ``on``), copy to the host each pseudo-label map that
    the port's CHAP step gets back from its largest-CC cleanup (K2), the
    ``largest_cc_batch`` it calls by name, into ``out``: the checked steps'
    pseudo-labels, which check.py holds to the reference's."""
    if not on:
        yield
        return
    from chap_tpu_torch.train import step_chap
    inner = step_chap.largest_cc_batch

    def recorded(*args, **kwargs):
        labels = inner(*args, **kwargs)
        out.append(labels.detach().to("cpu", torch.uint8))
        return labels
    step_chap.largest_cc_batch = recorded
    try:
        yield
    finally:
        step_chap.largest_cc_batch = inner


def _rows_distinct(image: torch.Tensor) -> bool:
    rows = image.reshape(image.shape[0], -1)
    return torch.unique(rows, dim=0).shape[0] == rows.shape[0]


class Cell:
    """One cell of the benchmark: a configuration under a traffic mix."""

    def __init__(self, conf: dict, traffic: dict, seed: int,
                 device: torch.device, trace: bool, scratch: Path):
        self.conf, self.traffic, self.seed = conf, traffic, int(seed)
        self.device, self.trace, self.scratch = device, trace, scratch
        self.cfg = port_config(conf["config"])
        self.ref_cfg = ref_config(conf["config"])
        self.rank = 2 if conf["pool"]["kind"] == "slices" else 3
        self.enqueue_s: List[float] = []
        self.program: Optional[dict] = None

    def gen(self, tag: int) -> torch.Generator:
        return data.generator(self.device, self.seed, tag)

    def peak_flops(self) -> float:
        return peaks.step_peak(self.cfg.model.dtype)


class TrainCell(Cell):
    """The ``train`` loop (module docstring)."""

    def setup(self) -> None:
        from chap_tpu_torch.data.device_data import (DevicePool, DeviceVolumePool,
                                                     build_device_batch_fn,
                                                     build_device_patch_fn)
        from chap_tpu_torch.models.factory import net_factory, net_factory_3d
        from chap_tpu_torch.models.layers import compute_dtype
        from chap_tpu_torch.semi.gradsim import VNET_LEVEL_PATHS
        from chap_tpu_torch.train.state import create_train_state, make_optimizer
        from chap_tpu_torch.train.step_chap import build_chap_train_step, level_channels
        from chap_tpu_torch.train.step_supervised import build_supervised_train_step

        cfg, dev, pool_conf = self.cfg, self.device, self.conf["pool"]
        self.mode = self.traffic["mode"]
        dtype = compute_dtype(cfg.model.dtype)
        n, n_lab = pool_conf["items"], pool_conf["labeled"]
        b, lbs = cfg.data.batch_size, cfg.data.labeled_bs
        if self.rank == 2:
            images, labels = data.slice_pool(n, tuple(cfg.data.image_size),
                                             self.gen(POOL), dtype)
            self.pool = (images, labels)
            self.port_pool = DevicePool(images, labels)
            self.batch_fn = build_device_batch_fn(n, n_lab, b, lbs)
            model = net_factory(cfg.model.name, cfg.data.in_chns,
                                cfg.data.num_classes, cfg.model, device=dev)
        else:
            extent = tuple(pool_conf["extent"])
            images, labels = data.volumes(n, extent, self.gen(POOL), dtype)
            shapes = torch.tensor([extent] * n, dtype=torch.int64, device=dev)
            self.pool = (images, labels, shapes)
            self.port_pool = DeviceVolumePool(images, labels, shapes)
            self.batch_fn = build_device_patch_fn(
                n, n_lab, b, lbs, tuple(cfg.data.patch_size_3d))
            model = net_factory_3d(cfg.model.name_3d, cfg.data.in_chns,
                                   cfg.data.num_classes, mode="train",
                                   cfg=cfg.model, device=dev)
        self.params0 = data.init_params(
            {k: p.shape for k, p in model.named_parameters()}, self.gen(WEIGHTS))
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(self.params0[k])
        optimizer = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                                   cfg.optim.weight_decay)
        if self.mode == "chap":
            state = create_train_state(model, optimizer,
                                       level_channels(cfg, self.rank))
            step = build_chap_train_step(
                model, optimizer, cfg, use_nms=True,
                **({} if self.rank == 2 else {"level_paths": VNET_LEVEL_PATHS}),
                device=dev)
        else:
            state = create_train_state(model, optimizer)
            step = build_supervised_train_step(model, optimizer, cfg, device=dev)
        self.state, self.step = state, step
        self.data_gen = self.gen(BATCHES)
        self.step_gen = self.gen(STEP_DRAWS)

        # the checked steps: the window's own feed and call, from the seed,
        # on batches whose rows all differ; draws made by the benchmark
        self.draw_counts: List[int] = []
        pseudo: List[torch.Tensor] = []
        with pseudo_labels(pseudo, self.mode == "chap"):
            self.program = self._checked_steps(
                model, optimizer, lambda: self.batch_fn(self.port_pool, self.data_gen),
                lambda batch, draws: step(state, batch, draws=draws),
                self.gen(CHECK_DRAWS), record_draws=True)
        self.program["pseudo"] = pseudo
        for _ in range(self.traffic["warmup_steps"]):
            self._one_step(False)
            self._log_copy(False)
        synchronize(dev)

    def _draws(self, image_shape, gen):
        from h100_bench.reference.train.step_chap import draw_step_uniforms
        from h100_bench.reference.train.step_supervised import draw_supervised_uniforms
        draw = draw_step_uniforms if self.mode == "chap" else draw_supervised_uniforms
        return draw(self.ref_cfg, tuple(image_shape), gen, self.device)

    def _checked_steps(self, model, optimizer, next_batch, call, draw_gen,
                       record_draws: bool, count: bool = False,
                       steps: Optional[int] = None) -> dict:
        """Run ``steps`` (default ``traffic.check_steps``) steps and record their losses (and
        the CHAP step's labeled loss), the first gradient (from SGD's
        momentum after step 1: momentum = grad + weight decay x the initial
        parameter), each leaf's change and each BatchNorm running
        statistic's change, after the first step and after the last. With
        ``record_draws`` the batches are drawn until their rows all differ
        and the number of draws is kept; otherwise ``self.draw_counts`` is
        replayed."""
        wd = self.cfg.optim.weight_decay
        params = dict(model.named_parameters())
        bn0 = self._bn_stats(model)
        metrics, grad1, bn1, flops = [], None, None, None
        for k in range(steps or self.traffic["check_steps"]):
            if record_draws:
                tries = 0
                while True:
                    batch = next_batch()
                    tries += 1
                    if _rows_distinct(batch["image"]) or tries == 16:
                        break
                self.draw_counts.append(tries)
            else:
                for _ in range(self.draw_counts[k]):
                    batch = next_batch()
            draws = self._draws(batch["image"].shape, draw_gen)
            out, f = counted(lambda: call(batch, draws), count and k == 0)
            flops = f if f is not None else flops
            metrics.append(out.metrics)
            if k == 0:
                grad1 = {n: self._first_grad(optimizer, p, self.params0[n], wd)
                         for n, p in params.items()}
                bn1 = self._bn_stats(model)
        bn = self._bn_stats(model)
        return {"loss": [float(m["loss"]) for m in metrics],
                "loss_l": [float(m.get("loss_l", m["loss"])) for m in metrics],
                "grad1": grad1,
                "change": {n: (p.detach() - self.params0[n]).clone()
                           for n, p in params.items()},
                "bn1_change": {k: bn1[k] - bn0[k] for k in bn},
                "bn_change": {k: bn[k] - bn0[k] for k in bn}, "flops": flops}

    @staticmethod
    def _first_grad(optimizer, p, p0, wd) -> torch.Tensor:
        """The gradient SGD got at the first step: its momentum buffer less
        the weight decay of the initial parameter; zero where it holds no
        buffer (it was given no gradient)."""
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is None:
            return torch.zeros_like(p0)
        return (buf - wd * p0).detach().clone()

    @staticmethod
    def _bn_stats(model) -> Dict[str, torch.Tensor]:
        from torch.nn.modules.batchnorm import _BatchNorm
        out = {}
        for name, m in model.named_modules():
            if isinstance(m, _BatchNorm):
                out[name + ".mean"] = m.running_mean.detach().clone()
                out[name + ".var"] = m.running_var.detach().clone()
        return out

    def _one_step(self, trace: bool):
        with span("bench.data", trace):
            batch = self.batch_fn(self.port_pool, self.data_gen)
        t = time.perf_counter()
        with span("bench.step", trace):
            self.state, self.metrics = self.step(self.state, batch, self.step_gen)
        return time.perf_counter() - t

    def _log_copy(self, trace: bool) -> None:
        """The trainer's one device->host copy of its logged scalars."""
        with span("bench.log", trace):
            values = [v.float() for v in self.metrics.values()]
            if self.state.sim_scores:
                flat = torch.cat([s.reshape(-1) for s in self.state.sim_scores])
                values += [flat.mean(), flat.std(correction=0), flat.abs().max()]
            torch.stack(values).tolist()

    def window(self, seconds: float) -> Tuple[int, float]:
        """(samples, seconds) of the measured window."""
        log_every = self.cfg.run.log_every
        steps = 0
        t0 = time.perf_counter()
        while True:
            dt = self._one_step(self.trace)
            self.enqueue_s.append(dt)
            steps += 1
            if steps % log_every == 0:
                self._log_copy(self.trace)
            if time.perf_counter() - t0 >= seconds:
                break
        synchronize(self.device)
        self.window_units = steps
        return steps * self.cfg.data.batch_size, time.perf_counter() - t0

    def stretch(self) -> Stretch:
        def run() -> int:
            for _ in range(self.traffic["profile_steps"]):
                self._one_step(True)
            return self.traffic["profile_steps"]
        return profile_stretch(run, self.scratch / "trace.json")

    def release(self) -> None:
        self.state = self.step = self.metrics = self.port_pool = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_record(self, precision: str, count: bool = False,
                         fault: Optional[str] = None,
                         steps: Optional[int] = None) -> dict:
        """The reference's record of the checked steps (the first ``steps``
        of them) at ``precision``, from the same pool, parameters and
        draws; ``fault`` plants one of the faults a training cell can have
        (calibrate.py). A CHAP step's record also holds each step's
        pseudo-labels (``pseudo``)."""
        from h100_bench.reference.build import build_train
        from h100_bench.reference.data.device_data import (DevicePool,
                                                           DeviceVolumePool,
                                                           build_device_batch_fn,
                                                           build_device_patch_fn)
        cfg, pool_conf = self.ref_cfg, self.conf["pool"]
        n, n_lab = pool_conf["items"], pool_conf["labeled"]
        b, lbs = cfg.data.batch_size, cfg.data.labeled_bs
        if self.rank == 2:
            pool = DevicePool(*self.pool)
            batch_fn = build_device_batch_fn(n, n_lab, b, lbs)
        else:
            pool = DeviceVolumePool(*self.pool)
            batch_fn = build_device_patch_fn(n, n_lab, b, lbs,
                                             tuple(cfg.data.patch_size_3d))
        pseudo: Dict[str, list] = {}
        state, step = build_train(cfg, self.rank, self.mode, precision,
                                  self.device, self.params0, pseudo)
        data_gen = self.gen(BATCHES)

        def call(batch, draws):
            if fault == "half_batch":
                batch, draws = _half_batch(batch, draws, self.mode, lbs)
            return step(state, batch, draws=draws)
        out = self._checked_steps(state.model, state.optimizer,
                                  lambda: batch_fn(pool, data_gen), call,
                                  self.gen(CHECK_DRAWS), record_draws=False,
                                  count=count, steps=steps)
        out["pseudo"] = pseudo.get("pseudo", [])
        return out

    def numbers(self, record: dict, wanted, count: bool = False
                ) -> Tuple[Dict[str, float], Optional[int]]:
        """(the numbers of ``record`` against the reference, the step's
        FLOPs when ``count``): check.train_numbers against float32 with
        TF32 off, and where ``wanted`` names it ``pseudo1`` against the
        reference's first step at the configuration's own precision."""
        tf32(False)
        try:
            ref = self.reference_record("float32", count)
        finally:
            tf32(True)
        out = train_numbers(record, ref)
        if "pseudo1" in wanted:
            own = self.reference_record(self.cfg.model.dtype, steps=1)
            out.update(pseudo_moved(record, own))
        return out, ref["flops"]

    def check(self, count: bool, wanted) -> Tuple[Dict[str, float], Optional[int]]:
        """(the numbers ``wanted`` and more, the step's FLOPs when ``count``)."""
        return self.numbers(self.program, wanted, count)

    def k_bytes(self) -> Dict[str, int]:
        """K1's and K2's bytes a step (counts/kernel_bytes.py)."""
        cfg = self.cfg
        spatial = (tuple(cfg.data.image_size) if self.rank == 2
                   else tuple(cfg.data.patch_size_3d))
        c = cfg.data.num_classes
        logit_bytes = 2 if cfg.model.dtype == "bfloat16" else 4
        b, lbs = cfg.data.batch_size, cfg.data.labeled_bs
        if self.mode == "chap":
            passes = 3 if cfg.semi.dropout and cfg.semi.gradsim_every == 1 else 1
            return {"k1": kernel_bytes.k1_bytes(4, lbs // 2, c, spatial, 2,
                                                logit_bytes, passes),
                    "k2": kernel_bytes.k2_bytes(2 * (b - lbs), spatial)}
        return {"k1": kernel_bytes.k1_bytes(2, b, c, spatial, 1, logit_bytes, 1)}


def _half_batch(batch, draws, mode: str, labeled_bs: int):
    """The fault 'half of the batch left out, the mean taken over the rest':
    every image row of the second half of each stream replaced by a copy
    of one in the first half, so the step's means run over half the rows."""
    image, label = batch["image"].clone(), batch["label"].clone()
    halves = ([(0, labeled_bs), (labeled_bs, image.shape[0])] if mode == "chap"
              else [(0, image.shape[0])])
    for lo, hi in halves:
        n = hi - lo
        keep = n - n // 2
        image[lo + keep:hi] = image[lo:lo + n // 2]
        label[lo + keep:hi] = label[lo:lo + n // 2]
    return {"image": image, "label": label}, draws


class EvalCell(Cell):
    """The ``sliding_window_eval`` loop (module docstring)."""

    def setup(self) -> None:
        from chap_tpu_torch.eval.sliding_window import SlidingWindowEngine
        from chap_tpu_torch.models.factory import net_factory_3d

        cfg, dev, t = self.cfg, self.device, self.traffic
        self.patch = tuple(cfg.data.patch_size_3d)
        images, _ = data.volumes(t["volumes"], tuple(t["extent"]), self.gen(POOL),
                                 torch.float32)
        self.volumes = [v for v in images.cpu().numpy()]
        del images
        model = net_factory_3d(cfg.model.name_3d, cfg.data.in_chns,
                               cfg.data.num_classes, mode="test", cfg=cfg.model,
                               device=dev)
        self.params0 = self._balanced(data.init_params(
            {k: p.shape for k, p in model.named_parameters()}, self.gen(WEIGHTS)))
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(self.params0[k])
        self.model = model
        self.engine = SlidingWindowEngine(model, self.patch, cfg.eval.sw_batch,
                                          device=dev)
        order = torch.randperm(len(self.volumes), generator=self.gen(ORDER),
                               device=dev).tolist()
        self.order = collections.deque(order)
        self.labels: Dict[int, np.ndarray] = {}
        self.run_volumes(t["warmup_volumes"])
        synchronize(dev)

    def _balanced(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Shift each decoder's last bias so that the reference's fp32
        logits at the centre patch of volume 0 favour either class on half
        of its voxels: random weights whose label maps are not all one
        class."""
        from h100_bench.reference.build import build_model, load_params
        model = build_model(self.ref_cfg, 3, False, "float32", self.device)
        load_params(model, params)
        vol = torch.from_numpy(self.volumes[0]).to(self.device)
        lo = [(s - p) // 2 for s, p in zip(vol.shape, self.patch)]
        x = vol[lo[0]:lo[0] + self.patch[0], lo[1]:lo[1] + self.patch[1],
                lo[2]:lo[2] + self.patch[2]][None, None]
        tf32(False)
        try:
            with torch.no_grad():
                outs = model.eval()(x)
        finally:
            tf32(True)
        for name, out in zip(("decoder1", "decoder2"), outs):
            margin = (out[:, 1:] - out[:, :1]).float().median()
            bias = params[f"{name}.out_conv.bias"].clone()
            bias[1:] -= margin
            params[f"{name}.out_conv.bias"] = bias
        del model
        return params

    def _volumes(self, trace: bool, more: Callable[[int], bool]) -> Tuple[int, int]:
        """Enqueue volumes ``depth`` deep, volume i + 1 before volume i is
        finalised, while ``more(volumes enqueued)``, then drain; returns
        (voxels, volumes) of the label maps that reached the host."""
        depth, c, ev = self.traffic["depth"], self.cfg.data.num_classes, self.cfg.eval
        pending = collections.deque()
        voxels = volumes = 0
        while True:
            vid = self.order[0]
            self.order.rotate(-1)
            with span("bench.enqueue", trace):
                pending.append((vid, self.engine.predict_async(
                    self.volumes[vid], ev.stride_xy, ev.stride_z, c)))
            volumes += 1
            if len(pending) >= depth:
                voxels += self._finalize(pending.popleft(), trace)
            if not more(volumes):
                break
        while pending:
            voxels += self._finalize(pending.popleft(), trace)
        return voxels, volumes

    def run_volumes(self, count: int, trace: bool = False) -> int:
        """Run ``count`` volumes; returns their voxels."""
        return self._volumes(trace, lambda n: n < count)[0]

    def _finalize(self, entry, trace: bool) -> int:
        vid, handle = entry
        with span("bench.finalize", trace):
            label = self.engine.finalize(handle, self.cfg.data.num_classes,
                                         self.cfg.eval.nms)
        self.labels[vid] = label
        return label.size

    def window(self, seconds: float) -> Tuple[int, float]:
        """(voxels, seconds): volumes enqueued until the window's time is
        up, then drained."""
        t0 = time.perf_counter()
        voxels, self.window_units = self._volumes(
            self.trace, lambda n: time.perf_counter() - t0 < seconds)
        synchronize(self.device)
        return voxels, time.perf_counter() - t0

    def stretch(self) -> Stretch:
        n = self.traffic["profile_volumes"]

        def run() -> int:
            self.run_volumes(n, True)
            return n
        return profile_stretch(run, self.scratch / "trace.json")

    def release(self) -> None:
        self.engine = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked_volumes(self) -> List[int]:
        """The finished volumes the check compares, drawn from the seed."""
        done = sorted(self.labels)
        rng = np.random.default_rng(data.sub_seed(self.seed, CHECK_DRAWS))
        k = min(self.traffic["check_volumes"], len(done))
        return sorted(rng.choice(done, size=k, replace=False).tolist())

    def reference_labels(self, precision: str, vids: List[int],
                         count: bool = False) -> Tuple[dict, Optional[int]]:
        """The reference's label maps of ``vids`` at ``precision``, and the
        FLOPs of the first volume's forwards when ``count``."""
        from h100_bench.reference.build import build_model, load_params
        from h100_bench.reference.eval.sliding_window import predict_volume
        cfg = self.ref_cfg
        model = build_model(cfg, 3, False, precision, self.device)
        load_params(model, self.params0)
        out, flops = {}, None
        for i, vid in enumerate(vids):
            vol = torch.from_numpy(self.volumes[vid]).to(self.device)
            out[vid], f = counted(lambda: predict_volume(
                model, vol, self.patch, cfg.eval.stride_xy, cfg.eval.stride_z,
                cfg.data.num_classes, cfg.eval.sw_batch, cfg.eval.nms),
                count and i == 0)
            flops = f if f is not None else flops
        return out, flops

    def check(self, count: bool, wanted=()) -> Tuple[Dict[str, float], Optional[int]]:
        vids = self.checked_volumes()
        tf32(False)
        try:
            ref, flops = self.reference_labels(self.cfg.model.dtype, vids, count)
        finally:
            tf32(True)
        return label_share({v: self.labels[v] for v in vids}, ref), flops

    def k_bytes(self) -> Dict[str, int]:
        """K3's bytes a volume (counts/kernel_bytes.py)."""
        from h100_bench.reference.eval.sliding_window import compute_grid
        cfg = self.cfg
        patches = len(compute_grid(tuple(self.traffic["extent"]), self.patch,
                                   cfg.eval.stride_xy, cfg.eval.stride_z))
        logit_bytes = 2 if cfg.model.dtype == "bfloat16" else 4
        return {"k3": kernel_bytes.k3_bytes(patches, 2, cfg.data.num_classes,
                                            self.patch, logit_bytes)}


LOOPS = {"train": TrainCell, "sliding_window_eval": EvalCell}
