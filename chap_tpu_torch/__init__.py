"""chap_tpu_torch — the PyTorch / CUDA port of chap_tpu for NVIDIA Hopper.

Mirrors chap_tpu's module paths (models/, losses/, semi/, train/, ops/ ...)
so each counterpart is easy to find. It imports neither JAX nor chap_tpu.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise (device.resolve_device).

Hand-written kernels (each with a plain PyTorch version beside it, used for
CPU tensors only, and a launch counter on its wrapper):
    ops/fused_losses.py   K1: fused masked dice+CE statistics (CUDA)
    semi/nms.py + csrc/   K2: union-find largest connected component (CUDA)
"""
