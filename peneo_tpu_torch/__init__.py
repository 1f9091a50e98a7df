"""peneo_tpu_torch: the PyTorch + CUDA port of peneo_tpu for NVIDIA Hopper.

A second package beside the JAX one (which stays the reference): the same
PEneo document key-value extraction (backbone + pair decoder), with the
TPU's Pallas kernels replaced by kernels written by hand for the H100
(``csrc/``, built with nvcc at first use). It imports torch and never jax,
flax or peneo_tpu.

Ported so far: batched serving (``pipeline.infer.InferenceService``,
``python -m peneo_tpu_torch.serve``) and fine-tuning
(``pipeline.trainer.PEneoTrainer``, ``python -m peneo_tpu_torch.run_rfund``)
of the LiLT family through the CUDA BiACM attention kernels and of the
LayoutLMv3 and LayoutLMv2/LayoutXLM families through the CUDA rel-bias
attention kernels.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
