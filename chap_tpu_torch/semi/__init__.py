"""Part of the chap_tpu_torch port; see the package docstring. The names
chap_tpu/semi/__init__.py re-exports (its JAX-only ``GradSimState`` alias
aside: the port's GradSim state is a list of tensors). Importing them
builds and loads no kernel."""
from chap_tpu_torch.semi.bcp import generate_mask  # noqa: F401
from chap_tpu_torch.semi.gradsim import init_sim_scores, update_grad_sim  # noqa: F401
from chap_tpu_torch.semi.memory_bank import ImageMemoryBank  # noqa: F401
from chap_tpu_torch.semi.nms import get_masks_with_nms, largest_cc_batch  # noqa: F401
from chap_tpu_torch.semi.patchmask import create_mask_v1  # noqa: F401
