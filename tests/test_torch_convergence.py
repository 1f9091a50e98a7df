"""Same-corpus convergence of the PyTorch port against the JAX package.

``tools/convergence_parity.py``'s design with the port in the reference's
place: both packages fine-tune from identical initial weights (the port's
seeded init read into JAX by ``peneo_tpu/models/convert.py``) on the same
synthetic RFUND corpus (written once; each side reads it with its own
dataset and collator, and the batches are checked equal) in the same batch
order (the tool's ``batch_schedule``: epoch shuffles, ragged tail dropped),
with the tool's constants and its ``compare`` (the port as "ours", JAX as
"ref"),
fp32 on the CPU, dropout 0, the 4-group AdamW (decoder ×30, no decay on
biases and norms) with linear warmup then decay and global-norm clipping,
through the warmup and into the decay. Then each side decodes a split
through its own decode and KVPE metric. The gates are the tool's: step 1's
loss within 5e-4 (relative), the first five within 2e-2, every window
mean within 10 % (fp32 drift compounds under the 30× decoder rate, so late
steps carry window-mean signal only), the decoded F1s within 0.05 — and the
JAX side's F1 above 0, so that the F1 check has content.

- ``test_convergence_lilt_tiny`` (tier 1): LiLT at hidden 48, 2 layers,
  L = 48, B = 4 over 4 train pages (one batch of every page a step), 300
  steps, lr 3e-4, warmup 0.1, 50-step windows, decoded on the train split
  (a tiny model from random weights learns no dev page; the tool's
  ``--eval_split train``). The step count is the least that gives a
  nonzero F1 (280 steps give 0 on both sides), and lr 3e-4 with 48 tokens
  the setting whose two trajectories stay close: these tiny runs are
  chaotic (at lr ≥ 5e-4, or 64 tokens, or 2 pages, both JAX runs on one
  and on eight threads part from each other, and from the port, by 10-130
  % in the late windows). Measured (about 60 s on one CPU thread; the
  same on eight): step-1 rel diff 9.7e-6, first five 1.0e-5 (JAX's loss
  is a plain fp32 sum over the grid: its own rounding), windows ≤ 8.2e-3;
  F1 0.2105 on both sides.
- ``test_convergence_dev`` (``slow``): the tool's dev geometry (hidden 96,
  4 layers, L = 192, B = 8, 48/16 pages, 400 steps, lr 5e-4, warmup 0.1,
  50-step windows) for LiLT and LayoutLMv3 (64 px page images), on the
  dev split, falling back to the train split when the JAX side's dev F1
  is 0. Run by hand (``-m slow``); its numbers are in ``ROADMAP.md`` §3.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LayoutLMv3Config, LiltConfig, PEneoConfig
from peneo_tpu.data.collator import PEneoCollator
from peneo_tpu.data.datasets import RFUNDDataset
from peneo_tpu.data.fetchers import fetch_xlm
from peneo_tpu.data.synthetic import ToyTokenizer, write_rfund_dataset
from peneo_tpu.models.convert import convert_peneo_checkpoint, \
    torch_state_dict_to_numpy
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.pipeline import decode as jax_decode
from peneo_tpu.pipeline import evaluation as jax_evaluation
from peneo_tpu.pipeline import train as jax_train
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.data.collator import PEneoCollator as PortCollator
from peneo_tpu_torch.data.datasets import RFUNDDataset as PortDataset
from peneo_tpu_torch.data.fetchers import fetch_xlm as port_fetch_xlm
from peneo_tpu_torch.data.image_processing import \
    layoutlmv3_preprocess as port_v3_image
from peneo_tpu_torch.data.synthetic import ToyTokenizer as PortTokenizer
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.pipeline import decode as port_decode
from peneo_tpu_torch.pipeline import evaluation as port_evaluation
from peneo_tpu_torch.pipeline import train as port_train
from peneo_tpu_torch.pipeline.loader import batch_to_device
from tools import convergence_parity as cp

torch.set_num_threads(1)

CATEGORY_WEIGHTS, SPEEDUP = cp.CATEGORY_WEIGHTS, cp.SPEEDUP
WEIGHT_DECAY, MAX_GRAD_NORM = cp.WEIGHT_DECAY, cp.MAX_GRAD_NORM
# the tool's fp32 gates (tools/convergence_parity.py, main)
STEP1_RTOL, FIRST5_RTOL, WINDOW_RTOL, F1_ATOL = 5e-4, 2e-2, 0.10, 0.05
# the tool's geometries (its dev ones run in the slow test) and a tiny one
GEOMETRIES = {**cp.GEOMETRIES, ("lilt", "tiny"): dict(
    cp.GEOMETRIES[("lilt", "dev")], hidden_size=48, num_hidden_layers=2,
    num_attention_heads=2, intermediate_size=96)}


def corpus(root, family, max_len, n_train, n_val, input_size):
    """The synthetic RFUND corpus written once, then each package's own
    (train, dev) datasets and collator over it."""
    data = write_rfund_dataset(os.path.join(root, "rfund"), n_train=n_train,
                               n_val=n_val, seed=11,
                               with_images=family != "lilt")
    add_sep = family == "layoutlmv3"  # the registry's flags (registry.py)
    sides = {}
    for side, (ds_cls, coll_cls, tok, fetch, image) in {
            "jax": (RFUNDDataset, PEneoCollator, ToyTokenizer(), fetch_xlm,
                    None),
            "port": (PortDataset, PortCollator, PortTokenizer(),
                     port_fetch_xlm, port_v3_image)}.items():
        if side == "jax" and family != "lilt":
            from peneo_tpu.data.image_processing import layoutlmv3_preprocess

            image = layoutlmv3_preprocess
        loader = (None if family == "lilt" else
                  (lambda p, f=image: f(p, input_size)))
        splits = [ds_cls(data, split, "en", tok, tokenizer_fetcher=fetch,
                         max_token_len=max_len - 1 - int(add_sep),
                         add_cls_token=True, add_sep_token=add_sep)
                  for split in ("train", "dev")]
        sides[side] = (splits, coll_cls(max_seq_len=max_len, pad_token_id=0,
                                        add_cls_token=True,
                                        image_loader=loader))
    return sides, ToyTokenizer().vocab_size


def collate(splits, coll, schedule, split=0):
    items = [splits[split][i] for i in range(len(splits[split]))]
    return [coll([items[i] for i in idxs]) for idxs in schedule]


def port_model(cfg):
    """The port's model at ``cfg`` with its seeded init, and the same weights
    as a JAX param tree."""
    port = PortModel(PortConfig.from_dict(cfg.to_dict())).init_weights(
        torch.Generator().manual_seed(0))
    params = convert_peneo_checkpoint(
        torch_state_dict_to_numpy(port.state_dict()), cfg)
    return port, jax.tree_util.tree_map(jnp.asarray, params)


def jax_batch(b, with_labels=True):
    d = {"input_ids": jnp.asarray(b.input_ids), "bbox": jnp.asarray(b.bbox),
         "attention_mask": jnp.asarray(b.attention_mask)}
    if b.image is not None:
        d["image"] = jnp.asarray(b.image)
    if with_labels:
        d["labels"] = {k: jnp.asarray(v) for k, v in b.labels.items()}
    return d


def run_jax(cfg, params, batches, lr, warmup):
    """The JAX trajectory's losses, and the trained model's decode and KVPE
    metric over a list of batches."""
    model = PEneoModel(cfg, dtype=jnp.float32)
    opt = jax_train.make_optimizer(
        params, lr=lr, total_steps=len(batches), warmup_ratio=warmup,
        weight_decay=WEIGHT_DECAY, downstream_speedup_ratio=SPEEDUP,
        max_grad_norm=MAX_GRAD_NORM)
    state = jax_train.create_train_state(cfg, model, opt,
                                         jax_batch(batches[0]), params=params)
    step = jax_train.jit_train_step(model, opt)
    losses = []
    for b in batches:
        state, m = step(state, jax_batch(b))
        losses.append(float(m["total"]))
    eval_step = jax.jit(jax_train.make_eval_step(model))

    def evaluate(eval_batches):
        pred, gt, fnames = [], [], []
        for b in eval_batches:
            out = jax.device_get(eval_step(state.params,
                                           jax_batch(b, with_labels=False)))
            p, g, f = jax_decode.decode_batch(b.texts, out, b.labels,
                                              [int(s) for s in b.seq_len],
                                              b.fnames)
            pred, gt, fnames = pred + p, gt + g, fnames + f
        return jax_evaluation.calculate_kvpe_metric(pred, gt, fnames)[0]

    return losses, evaluate


def run_port(port, batches, lr, warmup):
    """The port's trajectory's losses, and its decode and KVPE metric."""
    optimizer, scheduler = port_train.make_optimizer(
        port, lr=lr, total_steps=len(batches), warmup_ratio=warmup,
        weight_decay=WEIGHT_DECAY, downstream_speedup_ratio=SPEEDUP)
    losses = []
    for b in batches:
        m = port_train.train_step(port, optimizer, scheduler,
                                  batch_to_device(b, "cpu"), MAX_GRAD_NORM)
        losses.append(float(m["total"]))

    def evaluate(eval_batches):
        pred, gt, fnames = [], [], []
        with torch.inference_mode():
            for b in eval_batches:
                out = port_train.eval_step(port, batch_to_device(b, "cpu"))
                out = {n: {k: v.numpy() for k, v in h.items()}
                       for n, h in out.items()}
                p, g, f = port_decode.decode_batch(
                    b.texts, out, b.labels, [int(s) for s in b.seq_len],
                    b.fnames)
                pred, gt, fnames = pred + p, gt + g, fnames + f
        return port_evaluation.calculate_kvpe_metric(pred, gt, fnames)[0]

    return losses, evaluate


def convergence(tmp, family, geometry, steps, b, lr, warmup, max_len,
                n_train, n_val, window, eval_split):
    """Both trajectories and decoded evaluations; ``eval_split`` "dev"
    falls back to the train split when the JAX side's dev F1 is 0."""
    geom = GEOMETRIES[(family, geometry)]
    sides, vocab = corpus(tmp, family, max_len, n_train, n_val,
                          geom.get("input_size", 224))
    cls = LayoutLMv3Config if family == "layoutlmv3" else LiltConfig
    cfg = PEneoConfig(
        backbone_name=cp.FAMILY_BACKBONE[family],
        backbone_config=cls.from_dict(dict(
            geom, model_type=family, vocab_size=vocab, pad_token_id=0,
            max_position_embeddings=max_len + 8)).to_dict(),
        max_seq_len=max_len, pair_block_size=64,
        peneo_category_weights=CATEGORY_WEIGHTS,
        peneo_downstream_speedup_ratio=SPEEDUP, spot_topk="exact")
    schedule = cp.batch_schedule(len(sides["jax"][0][0]), b, steps)
    batches = {side: collate(*sides[side], schedule) for side in sides}
    for x, y in zip(batches["jax"], batches["port"]):
        np.testing.assert_array_equal(x.input_ids, y.input_ids)
        np.testing.assert_array_equal(x.bbox, y.bbox)
        for name in x.labels:
            np.testing.assert_array_equal(x.labels[name], y.labels[name])
        if x.image is not None:
            np.testing.assert_array_equal(x.image, y.image)
    port, params = port_model(cfg)
    jax_losses, jax_eval = run_jax(cfg, params, batches["jax"], lr, warmup)
    port_losses, port_eval = run_port(port, batches["port"], lr, warmup)
    # the tool's comparison, the port in the reference's place
    report = cp.compare(port_losses, jax_losses, steps, window)
    for split in ((1, 0) if eval_split == "dev" else (0,)):
        n = len(sides["jax"][0][split])
        order = [list(range(k, min(k + b, n))) for k in range(0, n, b)]
        jax_f1 = float(jax_eval(collate(*sides["jax"], order, split))["f1"])
        if jax_f1 > 0 or split == 0:
            break
    port_f1 = float(port_eval(collate(*sides["port"], order, split))["f1"])
    report.update(eval_split="dev" if split else "train",
                  losses_port=port_losses, losses_jax=jax_losses,
                  f1_port=port_f1, f1_jax=jax_f1)
    return report


def assert_gates(report):
    assert report["step1_rel_diff"] < STEP1_RTOL, report
    assert report["first5_max_rel_diff"] < FIRST5_RTOL, report
    assert report["max_window_rel_diff"] < WINDOW_RTOL, \
        report["window_means"]
    assert report["f1_jax"] > 0, report  # the F1 check has content
    assert abs(report["f1_port"] - report["f1_jax"]) < F1_ATOL, report
    assert all(np.isfinite(report["losses_port"]))
    # through warmup into the decay: the loss came down
    w = report["window_means"]
    assert w[-1]["ref_mean"] < w[0]["ref_mean"] \
        and w[-1]["ours_mean"] < w[0]["ours_mean"]


def test_convergence_lilt_tiny(tmp_path):
    report = convergence(str(tmp_path), "lilt", "tiny", steps=300, b=4,
                         lr=3e-4, warmup=0.1, max_len=48, n_train=4,
                         n_val=2, window=50, eval_split="train")
    assert_gates(report)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["lilt", "layoutlmv3"])
def test_convergence_dev(tmp_path, family):
    report = convergence(str(tmp_path), family, "dev", steps=400, b=8,
                         lr=5e-4, warmup=0.1, max_len=192, n_train=48,
                         n_val=16, window=50, eval_split="dev")
    print({k: v for k, v in report.items() if not k.startswith("losses")})
    assert_gates(report)
