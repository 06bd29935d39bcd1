"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), the yardstick of every roofline and utilization share."""

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {
    "bfloat16": 989e12,     # tensor cores
    "tf32": 495e12,         # tensor cores; cuDNN's default for float32 convolutions
    "float32": 67e12,       # outside the tensor cores
}


def step_peak(compute: str) -> float:
    """The FLOP rate a model computing in ``compute`` (``model.dtype``) can
    reach: bf16 on the tensor cores, and float32 convolutions as TF32,
    which PyTorch's cuDNN uses unless told otherwise and the port keeps."""
    return FLOP_PER_S["bfloat16" if compute == "bfloat16" else "tf32"]
