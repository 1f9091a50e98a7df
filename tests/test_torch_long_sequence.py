"""Long pages in the PyTorch port against the JAX package: the counterpart
of ``tests/test_long_sequence.py``, at its tiny LiLT config (hidden 48, one
layer, ``pair_block_size`` 128, ``max_spots_per_head`` 128) and L = 1024
and 2048 — a 1M- and a 4M-cell pair grid — with the decoder's init widened
to 0.15 as there (its logits spread to O(1), so that few argmax calls are
within fp32 rounding).

On identical weights (the port's seeded init read into JAX by
``peneo_tpu/models/convert.py``)
and identical random pages, at ``tests/test_torch_peneo.py``'s tolerances:
the dense logits of the five heads within 1e-4 (absolute); the compact top
128 spots of each head the same (``spot_count`` equal but for the positions
whose two largest class probabilities are within 1e-4, the tags equal and
the scores within 1e-5 where both keep a position, the kept scores sorted
within 1e-5, every spot clear of the 128th score kept by both: only a tie
at the 128th place may choose differently); the five losses and their
total within 1e-5 (relative); every parameter's gradient of the total
within 1e-3 of its largest |gradient| (or of 1e-6 of the model's largest,
for a gradient that is 0 in exact arithmetic, as the key bias's).

And the port's sequence-parallel path at both lengths in one process: the
decoder's ``sp_partials`` for both shards of sp 2 on the model's combine
features, merged with ``merge_spots``, against the one-process spots (the
CPU twin of ``chip_smoke.py``'s ``serve_sp_long``). The JAX side is jitted
(its own test runs the model op by op)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LiltConfig, PEneoConfig
from peneo_tpu.data.tagging import batch_spots_to_matrix
from peneo_tpu.models.convert import convert_peneo_checkpoint, \
    torch_state_dict_to_numpy
from peneo_tpu.models.decoder import compact_spots as jax_compact_spots
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.parallel.seq_parallel import merge_spots

torch.set_num_threads(1)
K = 128
LOGIT_ATOL = 1e-4
SCORE_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3  # of each parameter's largest |gradient|
ZERO_GRAD = 1e-6
MARGIN = 1e-4  # top-2 class probabilities this close may swap the argmax


def _long_cfg(L):
    return PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=64, hidden_size=48, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=L + 8, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0).to_dict(),
        pair_block_size=128, max_seq_len=L, max_spots_per_head=K,
        spot_topk="exact", initializer_range=0.15)


def _page(L, seed):
    """``tests/test_long_sequence.py``'s random page and spot labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 64, (1, L)).astype(np.int32)
    attn = np.ones((1, L), np.int32)
    x0 = rng.integers(0, 800, (1, L))
    bbox = np.stack([x0, x0, x0 + 30, x0 + 20], -1).astype(np.int32)
    Ld = L - 1
    labels = {}
    for name in HEAD_NAMES:
        spots = [[(int(i), int(min(i + 5, Ld - 1)), 1)
                  for i in rng.integers(0, Ld - 6, 10)]]
        labels[name] = batch_spots_to_matrix(spots, Ld)
    return ids, bbox, attn, labels


def _spots(out, name, b=0):
    """{flat index: (tag, score)} of one head's kept spots, and its count."""
    score = np.asarray(out[name]["spot_score"][b], np.float32)
    keep = score > -0.5
    idx = np.asarray(out[name]["spot_idx"][b])[keep]
    tag = np.asarray(out[name]["spot_tag"][b])[keep]
    return ({int(i): (int(t), float(s)) for i, t, s in
             zip(idx, tag, score[keep])},
            int(np.asarray(out[name]["spot_count"][b])))


def close_calls(logits):
    """Per head, the positions of the upper triangle whose two largest class
    probabilities are within MARGIN (fp32 rounding may pick either)."""
    out = {}
    for name in HEAD_NAMES:
        z = torch.from_numpy(np.asarray(logits[name]["logits"]))
        top2 = torch.softmax(z.double(), -1).topk(2, -1).values
        ld = z.shape[1]
        close = (top2[..., 0] - top2[..., 1]) <= MARGIN
        out[name] = int((close & torch.ones((ld, ld), dtype=torch.bool)
                         .triu()).sum())
    return out


def assert_spots_agree(want, got, close):
    """``close``: per head, how many positions may take another tag (and
    so count or not) on the two sides."""
    for name in HEAD_NAMES:
        w, w_count = _spots(want, name)
        g, g_count = _spots(got, name)
        assert abs(g_count - w_count) <= close[name], name
        both = set(w) & set(g)
        for i in both:
            assert g[i][0] == w[i][0], (name, i)
            assert abs(g[i][1] - w[i][1]) <= SCORE_TOL, (name, i)
        ws = np.sort([s for _, s in w.values()])[::-1]
        gs = np.sort([s for _, s in g.values()])[::-1]
        assert len(ws) == len(gs) == min(K, w_count), name
        np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_TOL,
                                   err_msg=name)
        kth = ws[-1] if w_count >= K else -1.0
        clear = {i for i, (_, s) in {**w, **g}.items()
                 if s > kth + SCORE_TOL}
        assert clear <= both, name
        assert len(both) >= K // 2, name  # the check has content


@pytest.fixture(scope="module", params=[1024, 2048], ids=["L1024", "L2048"])
def long_run(request):
    L = request.param
    ids, bbox, attn, labels = _page(L, seed=L)
    cfg = _long_cfg(L)
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    port = PortModel(port_cfg).init_weights(
        torch.Generator().manual_seed(0)).eval()
    # the port's seeded init read into JAX by its own converter
    params = convert_peneo_checkpoint(
        torch_state_dict_to_numpy(port.state_dict()), cfg)
    model = PEneoModel(cfg, dtype=jnp.float32)
    dense = jax.device_get(jax.jit(lambda p: model.apply(
        {"params": p}, ids, bbox, attn, deterministic=True,
        return_logits=True))(params))
    # the JAX model's compact path: compact_spots on its dense maps
    spots = {n: jax_compact_spots(dense[n]["tags"], dense[n]["scores"], K,
                                  "exact") for n in HEAD_NAMES}

    def total(p):
        out = model.apply({"params": p}, ids, bbox, attn, labels=labels,
                          deterministic=True)
        return out["total"], out

    (_, losses), grads = jax.device_get(
        jax.jit(jax.value_and_grad(total, has_aux=True))(params))

    inputs = [torch.from_numpy(x) for x in (ids, bbox, attn)]
    with torch.inference_mode():
        got_dense = port(*inputs, return_logits=True)
        got_spots = port(*inputs)
    port.zero_grad(set_to_none=True)
    got_losses = port(*inputs, labels={k: torch.from_numpy(v)
                                       for k, v in labels.items()})
    got_losses["total"].backward()
    return {"L": L, "close": close_calls(dense),
            "want": (dense, spots, losses,
                     jax_params_to_state_dict(grads, port_cfg)),
            "got": (got_dense, got_spots, got_losses, port),
            "inputs": inputs}


def test_logits_match_jax(long_run):
    dense, got = long_run["want"][0], long_run["got"][0]
    Ld = long_run["L"] - 1
    for name in HEAD_NAMES:
        assert got[name]["logits"].shape[1:3] == (Ld, Ld)
        np.testing.assert_allclose(got[name]["logits"].numpy(),
                                   np.asarray(dense[name]["logits"]),
                                   rtol=0, atol=LOGIT_ATOL, err_msg=name)


def test_spots_match_jax(long_run):
    spots, got = long_run["want"][1], long_run["got"][1]
    for name in HEAD_NAMES:
        assert tuple(got[name]["spot_idx"].shape) == (1, K)
        assert int(got[name]["seq_len"][0]) == long_run["L"] - 1
    assert_spots_agree(spots, {n: {k: v.numpy() for k, v in h.items()}
                               for n, h in got.items()}, long_run["close"])


def test_losses_match_jax(long_run):
    losses, got = long_run["want"][2], long_run["got"][2]
    assert set(got) == set(losses)
    for key in got:
        value = float(got[key].detach())
        assert np.isfinite(value), key
        np.testing.assert_allclose(value, float(losses[key]),
                                   rtol=LOSS_RTOL, err_msg=key)


def test_gradients_match_jax(long_run):
    want, port = long_run["want"][3], long_run["got"][3]
    named = dict(port.named_parameters())
    assert set(want) == set(named)
    # a gradient that is 0 in exact arithmetic (the key bias: the softmax
    # ignores a constant per row) is rounding on both sides: its scale is
    # 1e-6 of the model's largest gradient
    floor = ZERO_GRAD * max(np.abs(np.asarray(g)).max() for g in want.values())
    for name, p in named.items():
        ref = np.asarray(want[name])
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(ref).max(),
                                                       floor),
                                   err_msg=name)
    # the pair head and the backbone both take part
    assert np.abs(want["peneo_decoder.line_extraction_fc.0.weight"]).max() > 0
    assert np.abs(want["backbone.encoder.layer.0.attention.self.query.weight"]
                  ).max() > 0


def test_sp2_shards_merged_match_one_process(long_run):
    """sp 2 in one process (at L = 1024 and 2048): each shard's
    ``sp_partials`` on the same combine features, the two shards' packed
    candidates merged, against the one-process spots of the same model."""
    port, inputs = long_run["got"][3], long_run["inputs"]
    dec = port.peneo_decoder
    with torch.inference_mode():
        hidden = port.backbone(*inputs)["last_hidden_state"][:, 1:]
        a, b = dec.handshaking_kernel(dec.shrink_projection(hidden))
        Ld = hidden.shape[1]
        packed = torch.stack([dec.sp_partials(a, b, Ld, s, 2)[0].packed()
                              for s in range(2)])
        merged = merge_spots(packed, 1, K, Ld, HEAD_NAMES)
    want = long_run["got"][1]
    assert_spots_agree({n: {k: v.numpy() for k, v in h.items()}
                        for n, h in want.items()},
                       {n: {k: v.numpy() for k, v in h.items()}
                        for n, h in merged.items()}, long_run["close"])
    for name in HEAD_NAMES:
        assert int(merged[name]["seq_len"][0]) == Ld
