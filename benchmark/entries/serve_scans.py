"""Serving cells of a model that reads the page image (LayoutLMv3):
``entries/serve.py`` with four things of its own.

- The page writer: the traffic's directories with every page inked from
  its own OCR lines (``scans.py``), and the rows a page serves after its
  CLS counted as LayoutLMv3 holds them (its tokens up to L − 2, then the
  SEP: ``scans.served_tokens``).
- The weights (:func:`make_weights`): ``serve.py``'s, with the relative
  bias's three tables drawn :data:`BIAS_TABLE_SCALE` times wider, so that
  the bias is as large in the scores as q·k/√d. At the matrices' std the
  bias is about 1 % of the scores, and a bias dropped, or left undivided
  by √d, moves the states by less than rounding does.
- The page inputs (:func:`page_inputs`): a CLS, the lines up to L − 2
  tokens, a SEP, and the page image as LayoutLMv3's image processor makes
  it from the page file (``reference/layoutlmv3.py`` ``page_image``).
- The check (:func:`check_outputs`): the whole path's
  (:func:`check_pages`: the reference's forward takes the page's pixels
  beside its text, and its text positions after the CLS go to the
  decoder), ``serve.py``'s pair stage, and a backbone stage
  (:func:`check_backbone`). With random weights the text attends to the
  image's positions nearly alike, so a patch grid read in another order
  moves the served spots by less than rounding does; the image states show
  it.

Everything else is ``serve.py``'s: set-up, the window, the trace and the
pair stage. ``serve.run`` looks up ``pages``, ``make_weights``,
``PairStage`` and ``check_outputs`` in its module when it calls them, and
:func:`run` puts this entry's there for the call.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
from typing import Dict, List

import numpy as np
import torch
from torch.nn.modules.module import register_module_forward_hook

from .. import harness, scans
from ..reference import decoder as ref_decoder
from ..reference import judge
from ..reference import layoutlmv3 as ref_v3
from ..reference import pages as ref_pages
from . import serve

# 64 × the matrices' 0.02: tables of std 1.28 (a power of two times the
# draw, exact in bfloat16) give a summed bias of 1.28·√3/√64 ≈ 0.28 in the
# scores, where q·k/√d is ≈ 0.02²·768 ≈ 0.31
BIAS_TABLE_SCALE = 64


def run(ctx: Dict) -> Dict:
    """One run of a page-image serving cell (``serve.run``'s ``ctx``)."""
    with _in_serve(pages=scans, make_weights=make_weights, PairStage=Stages,
                   check_outputs=check_outputs):
        return serve.run(ctx)


@contextlib.contextmanager
def _in_serve(**names):
    saved = {k: getattr(serve, k) for k in names}
    for k, v in names.items():
        setattr(serve, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(serve, k, v)


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``serve.make_weights`` with the bias tables scaled up."""
    w = _MAKE_WEIGHTS(config, seed, device)
    for name in ref_v3.BIAS_TABLES:
        w[name].mul_(BIAS_TABLE_SCALE)
    return w


_MAKE_WEIGHTS = serve.make_weights


class Stages(serve.PairStage):
    """``serve.PairStage``, whose kept forward also keeps, under
    ``kept["backbone"]``, the backbone's text inputs (ids, boxes, mask), its
    output and the backbone module itself. The stage is built from the
    decoder alone: a global forward hook finds the backbone (the module
    called with an ``image`` that returns ``last_hidden_state``) at the
    window's first forward and hands over to a hook on that module."""

    def __init__(self, decoder, seed: int) -> None:
        super().__init__(decoder, seed)
        self.backbone, self.seen = None, None
        self.finder = register_module_forward_hook(self._find,
                                                   with_kwargs=True)
        self.handles.append(self.finder)

    def _find(self, module, args, kwargs, out):
        if (kwargs.get("image") is not None and isinstance(out, dict)
                and "last_hidden_state" in out):
            self.finder.remove()
            self.backbone = module
            self.handles.append(module.register_forward_hook(
                self._seen, with_kwargs=True))
            self._seen(module, args, kwargs, out)

    def _seen(self, module, args, kwargs, out):
        self.seen = (args[:3], out["last_hidden_state"])

    def _spots(self, module, args, out):
        before = self.kept
        super()._spots(module, args, out)
        if self.kept is not before and self.seen is not None:
            (ids, bbox, mask), hidden = self.seen
            self.kept["backbone"] = {
                "input_ids": ids.detach().clone(),
                "bbox": bbox.detach().clone(),
                "attention_mask": mask.detach().clone(),
                "hidden": hidden.detach().clone(),
                "module": self.backbone}
        self.seen = None


def page_inputs(image_path: str, ocr_path: str, max_seq_len: int,
                input_size: int) -> Dict:
    """One LayoutLMv3 page: ``reference/pages.py``'s inputs cut at
    ``max_seq_len - 2`` tokens with a SEP (box ``[0, 0, 0, 0]``) after the
    last, ``seq_len`` counting it, and ``image`` (3, S, S) float32."""
    page = ref_pages.page_inputs(image_path, ocr_path, max_seq_len,
                                 max_seq_len - 2)
    sep = page["seq_len"] + 1  # after the CLS and the tokens
    page["input_ids"][sep] = ref_pages.TOKENIZER["sep"]
    page["attention_mask"][sep] = 1
    page["boxes"].append([0, 0, 0, 0])
    page["seq_len"] += 1
    page["image"] = ref_v3.page_image(image_path, input_size)
    return page


def check_outputs(cell, config, jobs, kept, seed, device,
                  precision=None) -> Dict:
    """``serve.check_outputs`` for pages with an image: the whole path
    (:func:`check_pages`), the pair stage (``serve.check_pair_stage``)
    and the backbone stage (:func:`check_backbone`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = {k: v.float() for k, v in make_weights(config, seed, device).items()}
    checks = check_pages(cell, config, jobs, w, seed, device)
    checks.update(serve.check_pair_stage(cell, config, kept, w, precision))
    checks.update(check_backbone(cell, config, jobs, kept, w))
    return checks


def check_pages(cell, config, jobs, w, seed, device) -> Dict:
    """``serve.check_pages`` for pages with an image: the sampled pages'
    text and pixels through the plain reference, each page's served spots
    against its logits and its record against the reference's decode."""
    bb = harness.backbone_config(config)
    ref = harness.reference_module(config["family"])
    sample = serve.sample_pages(jobs, cell, seed)
    L = cell["max_seq_len"]
    k = config["peneo"]["max_spots_per_head"]
    squares, claims, mismatches = 0.0, 0, 0
    for start in range(0, len(sample), cell["check"]["reference_batch"]):
        part = sample[start:start + cell["check"]["reference_batch"]]
        inputs = []
        for j, img, _ in part:
            ocr = os.path.join(jobs[j]["dir"]["ocr"],
                               os.path.splitext(os.path.basename(img))[0]
                               + ".json")
            inputs.append(page_inputs(img, ocr, L, bb["input_size"]))
        batch = {key: torch.stack([torch.as_tensor(p[key]) for p in inputs])
                 .to(device)
                 for key in ("input_ids", "bbox", "attention_mask", "image")}
        with torch.no_grad():
            hidden = ref.forward(bb, w, **batch)
            for (j, img, _), page, h in zip(part, inputs, hidden):
                blocks = list(ref_decoder.pair_logits(w, h[1:L]))
                _, out, row = next(d for d in jobs[j]["decodes"]
                                   if d[0] == img)
                spots = {}
                for name, _classes in ref_decoder.HEADS:
                    flat, tag, score, grid, _ = judge.spots_of_page(
                        out[name], row)
                    sq, n = judge.head_errors(
                        ((r, c, lg[name]) for r, c, lg in blocks),
                        torch.as_tensor(flat, device=device),
                        torch.as_tensor(tag, device=device),
                        torch.as_tensor(score, device=device), k, grid)
                    squares += sq
                    claims += n
                    spots[name] = serve.page_spots(flat, tag, score, grid,
                                                   page["seq_len"])
                mine = ref_pages.record(page["texts"], page["boxes"], spots)
                served = dict(jobs[j]["results"][os.path.basename(img)])
                served.pop("seconds", None)
                mismatches += int(served != mine)
    rms = (squares / max(claims, 1)) ** 0.5
    limit = cell["check"]["spot_error_rms"]
    want = cell["check"]["sample_pages"]
    return {"pages_compared": {"value": len(sample), "limit": want,
                               "ok": len(sample) >= want},
            "spot_error_rms": {"value": rms, "limit": limit,
                               "ok": claims > 0 and rms <= limit},
            "record_mismatches": {"value": mismatches, "limit": 0,
                                  "ok": mismatches == 0}}


def check_backbone(cell, config, jobs, kept, w) -> Dict:
    """The backbone stage of the kept forward, in two parts, each against
    the reference's backbone in float32 on the program's own text inputs:

    - ``backbone_rel_error``: the kept forward's states, the reference
      reading each row's page file with its own image loader
      (``page_image``);
    - ``backbone_colour_rel_error``: the same rows again through the
      program's image loader, its normalization on the device and the
      kept backbone module, every page tinted in two colours
      (``scans.tinted``), the reference reading the tinted file. The
      grayscale pages served have equal channels; these tell a swap of
      them.

    A row's error: the rms of the difference over its real positions (the
    mask's text rows and every image position) over the rms of the
    reference's states there; compared: the median over the rows. Both
    take ``backbone_rel_error``'s limit. None compared fails."""
    got = (kept or {}).get("backbone")
    files = _kept_files(jobs, kept) if got is not None else {}
    rows = sorted(files)
    served, colour = [], []
    if rows:
        bb = harness.backbone_config(config)
        ref = harness.reference_module(config["family"])
        text = {k: got[k][rows] for k in
                ("input_ids", "bbox", "attention_mask")}
        with tempfile.TemporaryDirectory() as tmp:
            tints = [os.path.join(tmp, f"{r}.png") for r in rows]
            for r, path in zip(rows, tints):
                scans.tinted(files[r], path)
            programs = {
                "served": got["hidden"][rows].float(),
                "colour": _program_backbone(got["module"], text, tints,
                                            bb["input_size"],
                                            config["family"])}
            pixels = {"served": [files[r] for r in rows], "colour": tints}
            step = cell["check"]["reference_batch"]
            for part, errors in (("served", served), ("colour", colour)):
                for s in range(0, len(rows), step):
                    image = torch.stack([
                        ref_v3.page_image(p, bb["input_size"])
                        for p in pixels[part][s:s + step]]).to(
                            text["input_ids"].device)
                    with torch.no_grad():
                        mine = ref.forward(
                            bb, w, *(text[k][s:s + step] for k in
                                     ("input_ids", "bbox",
                                      "attention_mask")), image)
                    errors += _row_errors(
                        mine, programs[part][s:s + step],
                        text["attention_mask"][s:s + step])
    limit = cell["check"]["backbone_rel_error"]
    out = {"backbone_rows_compared": {
        "value": len(served), "limit": cell["batch_size"],
        "ok": len(served) >= cell["batch_size"]}}
    for name, rel in (("backbone_rel_error", served),
                      ("backbone_colour_rel_error", colour)):
        value = statistics.median(rel) if rel else 0.0
        out[name] = {"value": value, "limit": limit,
                     "ok": bool(rel) and value <= limit}
    return out


def _kept_files(jobs: List[Dict], kept: Dict) -> Dict[int, str]:
    """{batch row: page file} of the kept forward, found among the window's
    decodes by its spots (a batch's rows share one fetched output)."""
    want = {name: head["spot_idx"].cpu().numpy()
            for name, head in kept["spots"].items()}
    for job in jobs:
        for _, out, _ in job["decodes"]:
            if all(np.array_equal(out[name]["spot_idx"], idx)
                   for name, idx in want.items()):
                return {row: img for j in jobs
                        for img, o, row in j["decodes"] if o is out}
    return {}


def _program_backbone(module, text: Dict, paths: List[str], size: int,
                      family: str) -> torch.Tensor:
    """The program's states of ``text`` beside the page files ``paths``:
    its serving loader, its normalization on the device, ``module``."""
    from peneo_tpu_torch.data import image_processing

    pixels = np.stack([image_processing.load_rgb_u8(p, size)
                       for p in paths])
    with torch.inference_mode():
        image = image_processing.device_image_normalize(
            torch.from_numpy(pixels).to(text["input_ids"].device), family)
        out = module(text["input_ids"], text["bbox"],
                     text["attention_mask"], image=image)
    return out["last_hidden_state"].float()


def _row_errors(mine: torch.Tensor, theirs: torch.Tensor,
                mask: torch.Tensor) -> List[float]:
    """Per row, the rms of ``theirs − mine`` over the real positions over
    the rms of ``mine`` there."""
    text = mask.bool()
    real = torch.cat([text, text.new_ones(
        (text.shape[0], mine.shape[1] - text.shape[1]))], 1)
    out = []
    for m, t, r in zip(mine, theirs, real):
        scale = m[r].pow(2).mean().sqrt()
        out.append(float((t[r] - m[r]).pow(2).mean().sqrt() / scale))
    return out
