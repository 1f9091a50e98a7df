"""Sequence parallelism of the PyTorch port (peneo_tpu_torch/parallel/
seq_parallel.py, the decoder's row-sharded block loop, the dp × sp process
grid of parallel/dist.py, the trainer and the service under --sp), on the
CPU in fp32.

In process, shards are simulated by calling the decoder's ``sp_partials``
once per sp index and merging by hand (what a process group merges with
its collectives):

1. the strided layout covers every row once, balanced to within one row;
2. at sp 2 and 3 with Ld = 18 (the JAX test's odd size) the merged spots
   equal one pass's, the summed CE numerators and denominators give one
   pass's losses (relative 1e-6), the per-rank OHEM shares sum to one
   pass's OHEM loss, and the CE gradient of the summed shares is one
   pass's; the OHEM merge equals the dense OHEM through ties; a tiny
   LayoutLMv3 covers the rel-bias family;
3. against the JAX package's ``sp_pair_spots``, ``sp_pair_losses`` (CE and
   OHEM) and ``sp_pair_eval`` (with a row mask) at sp = 2 on the conftest's
   8 CPU devices, on the same weights and inputs: spots equal (scores
   relative 1e-5), losses within 1e-5;
4. the attention-dropout seeds reach kernel #2's (LiLT) and #5's
   (LayoutLMv3) plain twins offset by the dp index: the sp ranks of one dp
   index draw alike, two dp indices differently.

Spawned gloo ranks (tests/test_torch_dist.py's harness: a free local port,
the JAX trainer's coordinator flags, 120 s per subprocess, a tiny LiLT at
dropout 0): ``run_rfund --sp 2`` over 4 steps of CE and of OHEM reproduces
one process's losses (relative 1e-5) and eval metrics on both ranks; a
dp 2 × sp 2 run (4 ranks, 2 steps) reproduces one process; ``serve --sp 2``
writes one process's records.
"""

import json
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LayoutLMv3Config, LiltConfig, PEneoConfig
from peneo_tpu.data.tagging import batch_spots_to_matrix
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.ops.pair_head import stack_head_weights
from peneo_tpu.parallel import mesh as pmesh
from peneo_tpu.parallel.seq_parallel import (sp_pair_eval, sp_pair_losses,
                                             sp_pair_spots)
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.ops import losses as tl
from peneo_tpu_torch.parallel import dist as pdist
from peneo_tpu_torch.parallel import seq_parallel as sq

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 4, 19  # Ld = 18
K = 512       # above every pair position: no spot is dropped
RTOL = 1e-5


def _jax_cfg(family="lilt", **kw):
    common = dict(vocab_size=64, hidden_size=48, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=96,
                  max_position_embeddings=64, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0, pad_token_id=0)
    if family == "v3":
        name, bc = "layoutlmv3-base-chinese", LayoutLMv3Config(
            coordinate_size=8, shape_size=8, input_size=32, **common)
    else:
        name, bc = "lilt-infoxlm-base", LiltConfig(**common)
    return PEneoConfig(backbone_name=name, backbone_config=bc.to_dict(),
                       pair_block_size=4, initializer_range=0.3,
                       peneo_category_weights=[1.0, 10.0, 10.0],
                       peneo_downstream_speedup_ratio=30.0,
                       max_spots_per_head=K, spot_topk="exact", **kw)


def _inputs(family="lilt", seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, 900, (B, L))
    y0 = rng.integers(0, 900, (B, L))
    out = {"input_ids": rng.integers(2, 64, (B, L)).astype(np.int32),
           "bbox": np.stack([x0, y0, x0 + 50, y0 + 20], -1).astype(np.int32),
           "attention_mask": np.ones((B, L), np.int32)}
    if family == "v3":
        out["image"] = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
    Ld = L - 1
    labels = {}
    for name in HEAD_NAMES:
        c = 2 if name == "line_extraction" else 3
        spots = [[(int(i), int(rng.integers(i, Ld)), int(rng.integers(1, c)))
                  for i in rng.integers(0, Ld, 6)] for _ in range(B)]
        labels[name] = batch_spots_to_matrix(spots, Ld)
    return out, labels


def _models(family="lilt", **kw):
    """The JAX model and params, and the port model on the same weights."""
    cfg = _jax_cfg(family, **kw)
    x, _ = _inputs(family)
    image = {"image": x["image"]} if family == "v3" else {}
    model = PEneoModel(cfg, dtype=jnp.float32)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(0), x["input_ids"], x["bbox"],
        x["attention_mask"], deterministic=True, **image)["params"])
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    port = PortModel(port_cfg)
    port.load_state_dict(jax_params_to_state_dict(params, port_cfg))
    return model, params, port.eval()


def _port_pair_inputs(port, x):
    """The combine features (a, b) of the port model, as the decoder forms
    them, and Ld."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    visual = {"image": t["image"]} if "image" in t else {}
    h = port.backbone(t["input_ids"].long(), t["bbox"].long(),
                      t["attention_mask"], **visual)["last_hidden_state"]
    h = h[:, 1:t["input_ids"].shape[1]]
    dec = port.peneo_decoder
    a, b = dec.handshaking_kernel(dec.shrink_projection(h))
    return a, b, h.shape[1]


def _merged(dec, a, b, Ld, sp, labels=None, decode=True, row_mask=None):
    """Every shard's partials, merged as a process group merges them:
    (spots or None, [each shard's loss accumulators])."""
    parts = [dec.sp_partials(a, b, Ld, s, sp, labels, decode, row_mask)
             for s in range(sp)]
    spots = None
    if decode:
        packed = torch.stack([p[0].packed() for p in parts])
        spots = sq.merge_spots(packed, a.shape[0], dec.cfg.max_spots_per_head,
                               Ld, HEAD_NAMES)
    return spots, [p[1] for p in parts]


def _ce_losses(dec, accs, ref_device="cpu"):
    """Losses from the shards' summed CE numerators and denominators."""
    summed = {n: (sum(acc[n][0] for acc in accs),
                  sum(acc[n][1] for acc in accs)) for n in HEAD_NAMES}
    return dec._finish_losses(summed, ref_device, reduce=False)


def _spot_sets(d, bi):
    sc = np.asarray(d["spot_score"][bi])
    keep = sc > -0.5
    idx = np.asarray(d["spot_idx"][bi])[keep]
    order = np.argsort(idx)
    return (idx[order], np.asarray(d["spot_tag"][bi])[keep][order],
            sc[keep][order])


def _assert_spots_equal(ref, got):
    n_spots = 0
    for name in HEAD_NAMES:
        np.testing.assert_array_equal(np.asarray(ref[name]["spot_count"]),
                                      np.asarray(got[name]["spot_count"]))
        np.testing.assert_array_equal(np.asarray(ref[name]["seq_len"]),
                                      np.asarray(got[name]["seq_len"]))
        for bi in range(B):
            ri, rt, rs = _spot_sets(ref[name], bi)
            gi, gt, gs = _spot_sets(got[name], bi)
            np.testing.assert_array_equal(ri, gi, err_msg=name)
            np.testing.assert_array_equal(rt, gt, err_msg=name)
            np.testing.assert_allclose(gs, rs, rtol=RTOL, err_msg=name)
            n_spots += len(ri)
    assert n_spots > 100  # the random heads do tag pairs


def _t(labels):
    return {n: torch.from_numpy(np.asarray(m)) for n, m in labels.items()}


# layout ---------------------------------------------------------------------

@pytest.mark.parametrize("valid_len,sp", [(18, 2), (18, 3), (1, 1), (63, 2),
                                          (64, 4), (7, 3)])
def test_strided_rows_cover_every_row_once(valid_len, sp):
    shards = [sq.local_rows(valid_len, sp, s) for s in range(sp)]
    every = torch.sort(torch.cat(shards)).values
    assert torch.equal(every, torch.arange(valid_len))
    sizes = [len(r) for r in shards]
    assert max(sizes) - min(sizes) <= 1
    for s, rows in enumerate(shards):
        blocks = list(sq.row_blocks(len(rows), 4, sp))
        assert sum(n for _, n, _ in blocks) == len(rows)
        for r0, n, col0 in blocks:
            # the column skip keeps every column at or right of the block's
            # first global row
            assert col0 == r0 * sp <= int(rows[r0])


def test_local_labels_from_spots_and_dense():
    _, labels = _inputs()
    dense = {n: torch.from_numpy(np.asarray(m)) for n, m in labels.items()}
    rng = np.random.default_rng(4)
    spots = torch.from_numpy(np.stack([
        np.concatenate([rng.integers(0, 18, (5, 2)), rng.integers(1, 3, (5, 1))],
                       1) for _ in range(B)]))
    spots = torch.cat([spots, torch.full((B, 2, 3), 18)], 1)  # border rows
    from peneo_tpu_torch.models.decoder import dense_labels_from_spots

    full = dense_labels_from_spots(spots, 18)
    for sp in (2, 3):
        for s in range(sp):
            np.testing.assert_array_equal(
                sq.local_labels(spots, 18, sp, s), full[:, s::sp])
            m = dense["ent_linking_h2h"]
            np.testing.assert_array_equal(
                sq.local_labels(m, 18, sp, s), m[:, s::sp].long())


def test_spot_keys_order_by_score_then_lowest_index():
    """A top k over the keys is the top k in (score descending, flat index
    ascending) order, JAX's merge order, through ties; the keys decode to
    the index, tag and score; empty slots score -1."""
    rng = np.random.default_rng(3)
    n = 400
    scores = torch.from_numpy(rng.choice([0.25, 0.5, 0.75, 1.0], n)
                              .astype(np.float32))
    tags = torch.from_numpy(rng.integers(0, 3, n))
    flat = torch.from_numpy(rng.permutation(5000)[:n])
    ok = torch.from_numpy(rng.random(n) < 0.9)
    keys = sq.spot_keys(scores, tags, flat, ok)
    top = torch.topk(keys, 300).values
    idx, tag, score = sq.decode_keys(top)
    real = (ok & (tags != 0)).numpy()
    order = np.lexsort((flat.numpy()[real], -scores.numpy()[real]))
    m = int(real.sum())
    np.testing.assert_array_equal(idx[:m], flat.numpy()[real][order])
    np.testing.assert_array_equal(tag[:m], tags.numpy()[real][order])
    np.testing.assert_array_equal(score[:m], scores.numpy()[real][order])
    assert (score[m:] == -1).all() and (tag[m:] == 0).all()


# in process: shards merged by hand -----------------------------------------

@pytest.fixture(scope="module")
def built():
    """``_models`` by its arguments, built once for the module."""
    cache = {}

    def get(family="lilt", ohem=None):
        if (family, ohem) not in cache:
            kw = {} if ohem is None else dict(
                peneo_ohem_num_positive=ohem[0],
                peneo_ohem_num_negative=ohem[1])
            cache[family, ohem] = _models(family, **kw)
        return cache[family, ohem]

    return get


@pytest.fixture(scope="module")
def lilt(built):
    return built()


@pytest.fixture(scope="module")
def v3(built):
    return built("v3")


@pytest.mark.parametrize("family,sp", [("lilt", 2), ("lilt", 3), ("v3", 2),
                                       ("int8", 2)])
def test_sp_spots_equal_one_pass(family, sp, lilt, v3):
    """Also with the int8 pair head (``pair_block`` quantizes each pair's
    features on its own, whatever the block)."""
    if family == "int8":
        _, _, fp = lilt
        port = PortModel(PortConfig.from_dict(
            dict(fp.cfg.to_dict(), quantize_pair_head="int8")))
        port.load_state_dict(fp.state_dict())
        port.eval()
        family = "lilt"
    else:
        _, _, port = lilt if family == "lilt" else v3
    x, _ = _inputs(family)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        ref = port(t["input_ids"].long(), t["bbox"].long(),
                   t["attention_mask"], image=t.get("image"))
        a, b, Ld = _port_pair_inputs(port, x)
        got, _ = _merged(port.peneo_decoder, a, b, Ld, sp)
    _assert_spots_equal(ref, got)


@pytest.mark.parametrize("family,sp", [("lilt", 2), ("lilt", 3), ("v3", 2)])
def test_sp_ce_sums_equal_one_pass(family, sp, lilt, v3):
    _, _, port = lilt if family == "lilt" else v3
    x, labels = _inputs(family)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    row_mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    dec = port.peneo_decoder
    with torch.no_grad():
        a, b, Ld = _port_pair_inputs(port, x)
        for rm in (None, row_mask):
            ref = port(t["input_ids"].long(), t["bbox"].long(),
                       t["attention_mask"], labels=_t(labels),
                       label_row_mask=rm, image=t.get("image"))
            _, accs = _merged(dec, a, b, Ld, sp, _t(labels), decode=False,
                              row_mask=rm)
            got = _ce_losses(dec, accs)
            one = dec.sp_partials(a, b, Ld, 0, 1, _t(labels), False, rm)[1]
            for name in list(HEAD_NAMES) + ["total"]:
                np.testing.assert_allclose(float(got[name]), float(ref[name]),
                                           rtol=1e-6, err_msg=name)
            for name in HEAD_NAMES:  # the sums themselves
                for i in range(2):
                    np.testing.assert_allclose(
                        float(sum(acc[name][i] for acc in accs)),
                        float(one[name][i]), rtol=1e-6)


def test_sp_ce_gradient_equals_one_pass(lilt):
    """The gradient of the loss from the shards' summed sums (what DDP's
    world-scaled shares add up to) is one pass's, decoder and backbone."""
    _, _, port = lilt
    x, labels = _inputs()
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    grads = []
    for sp in (1, 2):
        port.zero_grad()
        if sp == 1:
            loss = port(t["input_ids"].long(), t["bbox"].long(),
                        t["attention_mask"], labels=_t(labels))["total"]
        else:
            a, b, Ld = _port_pair_inputs(port, x)
            _, accs = _merged(port.peneo_decoder, a, b, Ld, sp, _t(labels),
                              decode=False)
            loss = _ce_losses(port.peneo_decoder, accs)["total"]
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in port.named_parameters()
                      if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    for n, g in grads[0].items():
        # 1e-5 of each tensor's max |g|, or rounding where that is ~0 (the
        # key biases: softmax is blind to them)
        err = float((grads[1][n] - g).abs().max())
        assert err <= 1e-5 * float(g.abs().max()) + 1e-9, (n, err)


@pytest.mark.parametrize("sp", [2, 3])
def test_sp_ohem_shares_sum_to_one_pass(sp, built):
    _, _, port = built(ohem=(5, 12))
    x, labels = _inputs(seed=5)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    dec = port.peneo_decoder
    with torch.no_grad():
        ref = port(t["input_ids"].long(), t["bbox"].long(),
                   t["attention_mask"], labels=_t(labels))
        a, b, Ld = _port_pair_inputs(port, x)
        _, accs = _merged(dec, a, b, Ld, sp, _t(labels), decode=False)
    for name in HEAD_NAMES:
        states = [acc[name] for acc in accs]
        shares = [tl.ohem_stream_final(pdist.ohem_merge_states(states, s))
                  for s in range(sp)]
        np.testing.assert_allclose(float(sum(shares)), float(ref[name]),
                                   rtol=RTOL, err_msg=name)


def test_ohem_merge_equals_dense_ohem_through_ties():
    """Shards' streaming OHEM states over disjoint parts of the elements,
    merged: their shares sum to the dense OHEM over all elements, when the
    CE values tie across the shards (logits of three levels)."""
    rng = np.random.default_rng(7)
    for case in range(12):
        sp = int(rng.integers(2, 5))
        k_pos, k_neg = [int(v) for v in rng.choice([-1, 1, 3, 9, 40], 2)]
        logits = torch.from_numpy(
            rng.integers(-1, 2, (2, 12, 12, 3)).astype(np.float32))
        targets = torch.from_numpy(rng.integers(0, 3, (2, 12, 12)))
        mask = torch.from_numpy(rng.random((2, 12, 12)) < 0.8)
        w = torch.tensor([1.0, 10.0, 10.0])
        dense = tl.ohem_cross_entropy(logits, targets, w, mask, k_pos, k_neg)
        states = []
        for s in range(sp):  # shard s: rows s, s + sp, ...
            st = tl.ohem_stream_init(k_pos, k_neg)
            states.append(tl.ohem_stream_update(
                st, logits[:, s::sp], targets[:, s::sp], w, mask[:, s::sp]))
        total = sum(tl.ohem_stream_final(pdist.ohem_merge_states(states, s))
                    for s in range(sp))
        np.testing.assert_allclose(float(total), float(dense), rtol=1e-6,
                                   err_msg=f"case {case}")


# against the JAX package's sp functions -------------------------------------

def _jax_sp(model, params, x, mesh_sp=2):
    mesh = pmesh.make_mesh(dp=1, tp=1, sp=mesh_sp,
                           devices=jax.devices()[:mesh_sp])
    image = {"image": x["image"]} if "image" in x else {}
    pair_in = model.apply({"params": params}, x["input_ids"], x["bbox"],
                          x["attention_mask"], deterministic=True,
                          return_pair_inputs=True, **image)
    weights = stack_head_weights(params["peneo_decoder"], HEAD_NAMES,
                                 jnp.float32)
    return mesh, pair_in, weights


def test_sp_spots_match_jax(lilt):
    model, params, port = lilt
    x, _ = _inputs()
    mesh, pair_in, weights = _jax_sp(model, params, x)
    want = sp_pair_spots(pair_in["a"], pair_in["b"], weights, mesh, K,
                         valid_len=int(pair_in["valid_len"]))
    with torch.no_grad():
        a, b, Ld = _port_pair_inputs(port, x)
        got, _ = _merged(port.peneo_decoder, a, b, Ld, 2)
    _assert_spots_equal(jax.device_get(want), got)


@pytest.mark.parametrize("ohem", [None, (5, 12)], ids=["ce", "ohem"])
def test_sp_losses_match_jax(ohem, built):
    model, params, port = built(ohem=ohem)
    x, labels = _inputs(seed=5)
    mesh, pair_in, weights = _jax_sp(model, params, x)
    cfg = model.cfg
    want = sp_pair_losses(pair_in["a"], pair_in["b"], weights, labels,
                          cfg.peneo_category_weights, [1.0] * 5, mesh,
                          valid_len=int(pair_in["valid_len"]),
                          num_hard_positive=cfg.peneo_ohem_num_positive,
                          num_hard_negative=cfg.peneo_ohem_num_negative)
    dec = port.peneo_decoder
    with torch.no_grad():
        a, b, Ld = _port_pair_inputs(port, x)
        _, accs = _merged(dec, a, b, Ld, 2, _t(labels), decode=False)
    if ohem is None:
        got = _ce_losses(dec, accs)
    else:
        got = {name: sum(tl.ohem_stream_final(pdist.ohem_merge_states(
            [acc[name] for acc in accs], s)) for s in range(2))
               for name in HEAD_NAMES}
        got["total"] = sum(got.values())
    for name in list(HEAD_NAMES) + ["total"]:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=RTOL, err_msg=name)


def test_sp_eval_matches_jax_with_row_mask(lilt):
    """One pass for spots and losses, the last sample kept out of the losses
    by the row mask (the trainer's edge-padded ragged batch)."""
    model, params, port = lilt
    x, labels = _inputs(seed=2)
    mesh, pair_in, weights = _jax_sp(model, params, x)
    row_mask = np.asarray([1, 1, 1, 0], np.float32)
    want_spots, want = sp_pair_eval(
        pair_in["a"], pair_in["b"], weights, labels,
        model.cfg.peneo_category_weights, [1.0] * 5, mesh, K,
        valid_len=int(pair_in["valid_len"]), row_mask=jnp.asarray(row_mask))
    dec = port.peneo_decoder
    with torch.no_grad():
        a, b, Ld = _port_pair_inputs(port, x)
        got_spots, accs = _merged(dec, a, b, Ld, 2, _t(labels),
                                  row_mask=torch.from_numpy(row_mask))
    got = _ce_losses(dec, accs)
    _assert_spots_equal(jax.device_get(want_spots), got_spots)
    for name in list(HEAD_NAMES) + ["total"]:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=RTOL, err_msg=name)


# dropout seeds by dp index --------------------------------------------------

@pytest.mark.parametrize("family", ["lilt", "v3"])
def test_dp_index_seed_reaches_the_kernel_twin(family, monkeypatch):
    """Ranks 0 and 1 of a dp 2 × sp 2 grid (dp index 0) draw kernel #2's
    (LiLT) or #5's (LayoutLMv3) dropout bits from the same layer seeds and
    reach the same hidden states; rank 2 (dp index 1) draws from seeds
    offset by 1000003."""
    from peneo_tpu_torch.models import dropout_seeds as ds
    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb

    ops = rb if family == "v3" else ba
    name = ("element_dropout_bits" if family == "v3"
            else "attention_dropout_bits")
    seen = []
    draw = getattr(ops, name)

    def record(seed, *a, **kw):
        seen.append(int(seed))
        return draw(seed, *a, **kw)

    monkeypatch.setattr(ops, name, record)
    cfg = _jax_cfg(family)
    cfg.backbone_config["attention_probs_dropout_prob"] = 0.1
    port = PortModel(PortConfig.from_dict(cfg.to_dict())).init_weights(
        torch.Generator().manual_seed(1)).train()
    x, _ = _inputs(family)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    visual = {"image": t["image"]} if family == "v3" else {}
    monkeypatch.setattr(pdist, "_grid", pdist.ProcessGrid(dp=2, sp=2))
    hidden, seeds = {}, {}
    for r in (0, 1, 2):
        monkeypatch.setattr(pdist, "rank", lambda r=r: r)
        assert (pdist.dp_index(), pdist.sp_index()) == divmod(r, 2)
        seen.clear()
        with torch.no_grad():
            hidden[r] = port.backbone(
                t["input_ids"].long(), t["bbox"].long(),
                t["attention_mask"], generator=ds.HostSeeds(
                    torch.Generator().manual_seed(9), pdist.dp_index()),
                **visual)["last_hidden_state"]
        seeds[r] = list(seen)
    assert len(seeds[0]) == 2, seeds  # one per layer
    assert seeds[1] == seeds[0]
    assert seeds[2] == [s + ds.RANK_STRIDE for s in seeds[0]]
    assert torch.equal(hidden[0], hidden[1])
    assert (hidden[0] - hidden[2]).abs().max() > 1e-3


# refusals ---------------------------------------------------------------------

def test_sp_without_a_process_group_raises(tmp_path):
    from peneo_tpu_torch import run_rfund, serve

    with pytest.raises(ValueError, match="--sp 2"):
        run_rfund.main(["--output_dir", str(tmp_path), "--device", "cpu",
                        "--sp", "2"])
    with pytest.raises(ValueError, match="torchrun"):
        serve.main(["--model_name_or_path", str(tmp_path), "--dir_image",
                    str(tmp_path), "--dir_ocr", str(tmp_path), "--device",
                    "cpu", "--sp", "2"])


# spawned gloo ranks -------------------------------------------------------------

TIMEOUT = 120
LT = 64        # the spawned runs' sequence length
STEPS = 4

WORKER = r"""
import json, os, sys
repo, mode, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, repo)
import torch
torch.set_num_threads(1)
from peneo_tpu_torch.parallel import dist as pdist
if mode == "serve":
    from peneo_tpu_torch import serve
    records = serve.main(argv)
    print("RESULT " + json.dumps({"rank": pdist.rank(), "pages":
                                  len(records)}), flush=True)
    sys.exit(0)
from peneo_tpu_torch import run_rfund
from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

args = run_rfund.build_argparser().parse_args(argv)
run_rfund.init_parallel(args)
cfg, model, train_ds, eval_ds, collator, tok = run_rfund.setup(args)
trainer = PEneoTrainer(cfg, model, run_rfund.training_arguments(args),
                       train_ds, eval_ds, collator, tokenizer=tok)
losses = []
log = trainer.log

def capture(record):
    if "loss/total" in record:
        losses.append(record["loss/total"])
    log(record)

trainer.log = capture
trainer.train()
result = {"rank": pdist.rank(), "world": pdist.world(),
          "dp": [pdist.dp_index(), pdist.dp_size()],
          "sp": [pdist.sp_index(), pdist.sp_size()],
          "seed_offset": trainer.seeds.offset, "losses": losses,
          "eval": trainer.evaluate()}
print("RESULT " + json.dumps(result), flush=True)
pdist.barrier()
pdist.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(mode, argv, nproc):
    """``nproc`` worker processes (a process group when > 1)."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for pid in range(nproc):
        extra = ([] if nproc == 1 else
                 ["--coordinator_address", f"localhost:{port}",
                  "--num_processes", str(nproc), "--process_id", str(pid)])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, REPO, mode,
             json.dumps(argv + extra)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    return procs


def _results(procs):
    """The workers' RESULT records in rank order. A worker that fails or
    outlives the timeout fails the test, and every worker is killed."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, \
                f"worker failed:\n{out[-2000:]}\n{err[-3000:]}"
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT ")][-1]
            results.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _write_model(path, ohem=None):
    from peneo_tpu_torch.config import LiltConfig as PortLilt
    from peneo_tpu_torch.data.synthetic import ToyTokenizer

    os.makedirs(path)
    tok = ToyTokenizer()
    kw = {} if ohem is None else dict(peneo_ohem_num_positive=ohem[0],
                                      peneo_ohem_num_negative=ohem[1])
    cfg = PortConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=PortLilt(
            vocab_size=tok.vocab_size, pad_token_id=0, hidden_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=96, max_position_embeddings=LT + 16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            initializer_range=0.15).to_dict(),
        pair_block_size=16, initializer_range=0.15,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=30.0, **kw)
    model = PortModel(cfg).init_weights(torch.Generator().manual_seed(0))
    cfg.save_pretrained(path)
    tok.save_pretrained(path)
    torch.save(model.state_dict(), os.path.join(path, "pytorch_model.bin"))
    return path


def _argv(model_dir, data_dir, out, per_dp, steps=STEPS, **flags):
    argv = ["--synthetic_data", "--model_name_or_path", model_dir,
            "--data_dir", data_dir, "--output_dir", out, "--device", "cpu",
            "--dtype", "float32", "--max_seq_len", str(LT),
            "--max_steps", str(steps), "--logging_steps", "1",
            "--eval_steps", "0", "--save_steps", "0",
            "--learning_rate", "1e-3", "--warmup_ratio", "0",
            "--per_device_train_batch_size", str(per_dp),
            "--per_device_eval_batch_size", "4",
            "--metric_for_best_model", "", "--no_resume"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """CE and OHEM 5/7: two sp ranks and one process on the same global
    batches (4 a step), started together; then a dp 2 × sp 2 run of 2
    steps beside them."""
    from peneo_tpu_torch.data.synthetic import write_rfund_dataset

    base = tmp_path_factory.mktemp("sp_runs")
    data = str(base / "data")
    write_rfund_dataset(data, "en", n_train=16, n_val=6, seed=3)
    runs = {}
    for loss, ohem in (("ce", None), ("ohem", (5, 7))):
        model_dir = _write_model(str(base / f"model_{loss}"), ohem)
        sp_procs = _start("train", _argv(model_dir, data,
                                         str(base / f"sp_{loss}"), 4, sp=2),
                          2)
        solo_procs = _start("train", _argv(model_dir, data,
                                           str(base / f"solo_{loss}"), 4), 1)
        runs[loss] = {"sp": _results(sp_procs),
                      "solo": _results(solo_procs)[0],
                      "model_dir": model_dir}
    runs["grid"] = _results(_start(
        "train", _argv(runs["ce"]["model_dir"], data, str(base / "grid"), 2,
                       steps=2, dp=2, sp=2), 4))
    return runs


@pytest.mark.parametrize("loss", ["ce", "ohem"])
def test_sp_ranks_reproduce_one_process(spawned, loss):
    sp, solo = spawned[loss]["sp"], spawned[loss]["solo"]
    assert [(r["world"], r["sp"], r["dp"]) for r in sp] == \
        [(2, [0, 2], [0, 1]), (2, [1, 2], [0, 1])]
    assert sp[0]["seed_offset"] == sp[1]["seed_offset"] == 0
    assert len(solo["losses"]) == STEPS
    assert sp[0]["losses"] == sp[1]["losses"]
    np.testing.assert_allclose(sp[0]["losses"], solo["losses"], rtol=1e-5)
    assert solo["losses"][-1] != solo["losses"][0]


def test_sp_eval_equals_one_process_on_both_ranks(spawned):
    timing = "eval_samples_per_second"
    for loss in ("ce", "ohem"):
        sp, solo = spawned[loss]["sp"], spawned[loss]["solo"]
        a, b = ({k: v for k, v in r["eval"].items() if k != timing}
                for r in sp)
        assert a == b
        assert a["num_sample_processed"] == 6
        for key, value in solo["eval"].items():
            if key != timing:
                np.testing.assert_allclose(a[key], value, rtol=1e-5,
                                           atol=1e-7, err_msg=key)


def test_dp2_sp2_grid_reproduces_one_process(spawned):
    grid = spawned["grid"]
    assert [(r["dp"][0], r["sp"][0]) for r in grid] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    # the sp ranks of a dp index share its seed offset; dp indices differ
    assert [r["seed_offset"] for r in grid] == [0, 0, 1000003, 1000003]
    for r in grid:
        np.testing.assert_allclose(r["losses"],
                                   spawned["ce"]["solo"]["losses"][:2],
                                   rtol=1e-5)
        assert r["eval"]["num_sample_processed"] == 6


def test_serve_sp_writes_one_process_records(tmp_path):
    from PIL import Image

    from peneo_tpu_torch.data.synthetic import make_document, render_page

    model_dir = _write_model(str(tmp_path / "model"))
    img_dir, ocr_dir = tmp_path / "images", tmp_path / "ocr"
    img_dir.mkdir()
    ocr_dir.mkdir()
    rng = random.Random(8)
    for i in range(5):
        doc = make_document(rng, f"p{i}.png", n_pairs=4, n_noise=1)
        Image.fromarray(render_page(doc)).save(img_dir / f"p{i}.png")
        with open(ocr_dir / f"p{i}.json", "w") as f:
            json.dump([{"text": ln["text"], "bbox": ln["bbox"]}
                       for e in doc["entities"] for ln in e["lines"]], f)

    def argv(out, **flags):
        a = ["--model_name_or_path", model_dir, "--dir_image", str(img_dir),
             "--dir_ocr", str(ocr_dir), "--dir_save", str(out),
             "--device", "cpu", "--dtype", "float32", "--batch_size", "2",
             "--max_seq_len", str(LT)]
        for k, v in flags.items():
            a += [f"--{k}", str(v)]
        return a

    procs = _start("serve", argv(tmp_path / "sp.json", sp=2), 2)
    solo = _start("serve", argv(tmp_path / "solo.json"), 1)
    ranks, one = _results(procs), _results(solo)[0]
    assert [r["pages"] for r in ranks] == [5, 5] and one["pages"] == 5
    with open(tmp_path / "sp.json") as f:
        got = json.load(f)
    with open(tmp_path / "solo.json") as f:
        want = json.load(f)
    assert list(got) == list(want) == [f"p{i}.png" for i in range(5)]
    for name, record in want.items():  # all but the timing
        assert got[name]["kv_pairs"] == record["kv_pairs"], name
        assert got[name]["lines"] == record["lines"], name
    assert sum(len(r["lines"]) for r in want.values()) > 5
