"""Serving from an exported artifact: the forward is the loaded
``torch.export`` program, not a model rebuilt from Python.

Counterpart of ``deploy/inference_artifact.py``. The host side (the page
preprocessor, batching, the pipelined dispatch and collect, the host
decode) is :class:`~peneo_tpu_torch.pipeline.infer.PageServer`, shared with
the live :class:`~peneo_tpu_torch.pipeline.infer.InferenceService`. As the
JAX artifact, the program returns the heads' compact-spot dicts (no packed
transport), takes normalized fp32 page images and runs at its one exported
(batch, max_seq_len): no length buckets. The pages travel as the live
service ships them, resized uint8 normalized on the device
(``device_image_normalize``): the program then gets the live forward's
image tensor, values and strides alike. (On the card an exported graph's
roundings depend on the image's strides: LayoutXLM's artifact on
host-normalized NCHW images left the live forward's spots by bf16
rounding, on the device-normalized ones it gives them bit for bit.)

    python -m peneo_tpu_torch.inference_artifact --artifact_dir ART \\
        --dir_image IMGS --dir_ocr OCR --dir_save out.json \\
        [--dir_visualize V] [--score_thresh T] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; the artifact must have
been exported for the same device type.
"""

from __future__ import annotations

import argparse
import json

import torch

from .export_artifact import load_artifact
from .pipeline.infer import PageServer


class ArtifactInferenceService(PageServer):
    """Page → kv-pair extraction through an exported artifact."""

    def __init__(self, artifact_dir: str, tokenizer=None,
                 score_thresh: float = 0.0, device=None) -> None:
        call, meta, cfg = load_artifact(artifact_dir, device)
        if tokenizer is None:
            from .registry import get_backbone_info, load_tokenizer

            tokenizer = load_tokenizer(get_backbone_info(cfg.backbone_name),
                                       artifact_dir)
        super().__init__(cfg, torch.device(meta["device"]), tokenizer,
                         meta["batch_size"], score_thresh, raw_image=True)
        self._call = call
        self._packed = False

    def _forward(self, input_ids, bbox, attention_mask, image):
        return self._call(input_ids, bbox, attention_mask, image=image)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact_dir", type=str, required=True)
    p.add_argument("--dir_image", type=str, required=True)
    p.add_argument("--dir_ocr", type=str, required=True)
    p.add_argument("--dir_save", type=str, default="inference_results.json")
    p.add_argument("--dir_visualize", type=str, default=None)
    p.add_argument("--score_thresh", type=float, default=0.0)
    p.add_argument("--device", type=str, default=None,
                   help="cpu to serve on the CPU (default: the GPU)")
    args = p.parse_args(argv)
    service = ArtifactInferenceService(args.artifact_dir,
                                       score_thresh=args.score_thresh,
                                       device=args.device)
    results = service.run(args.dir_image, args.dir_ocr,
                          visualize_dir=args.dir_visualize)
    with open(args.dir_save, "w", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False, indent=1)
    print(f"[peneo] wrote {args.dir_save}")
    return results


if __name__ == "__main__":
    main()
