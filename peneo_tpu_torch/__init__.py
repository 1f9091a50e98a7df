"""peneo_tpu_torch: the PyTorch + CUDA port of peneo_tpu for NVIDIA Hopper.

A second package beside the JAX one (which stays the reference): the same
PEneo document key-value extraction (backbone + pair decoder), with the
TPU's Pallas kernels replaced by kernels written by hand for the H100
(``csrc/``, built with nvcc at first use). It imports torch and never jax,
flax or peneo_tpu.

Ported so far: batched serving (``pipeline.infer.InferenceService``,
``python -m peneo_tpu_torch.serve``: ``run``/``run_page``/``run_batch``,
preprocessing worker processes, tesseract OCR, visualization, int8 pair
head and backbone) and fine-tuning (``pipeline.trainer.PEneoTrainer``,
``python -m peneo_tpu_torch.run_rfund``) of the LiLT family through the
CUDA BiACM attention kernels and of the LayoutLMv3 and LayoutLMv2/LayoutXLM
families through the CUDA rel-bias attention kernels; every checkpoint the
JAX package reads (``params.msgpack``, ``model.safetensors``,
``pytorch_model.bin``, ``backbone_params.msgpack`` from
``python -m peneo_tpu_torch.generate_peneo_weights``). Not yet: the
multi-device paths and the ``--*fused*`` switches (the port always runs its
CUDA kernels).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
