"""Streaming spot extraction (``config.spot_streaming``) of the PyTorch port
against its dense path and against the JAX package's streaming path, on
the same decoder weights (JAX's init carried over by ``models/convert.py``)
and the same numpy inputs, on the CPU in fp32.

The cases are ``tests/test_spot_streaming.py``'s: a ragged L, fewer
candidates than slots, several blocks with a small k. In each:

- the port's streamed spots equal its dense ones bit for bit on the live
  slots (score >= 0), with equal ``spot_count``, and JAX's streamed spots
  (scores within 1e-5; where the counts overflow k, the sorted scores);
- eval with ``also_decode``: the losses within 1e-6 of the dense path's and
  within 1e-5 of JAX's, the same spots;
- on the streamed path no (B, L, L) int32 or fp32 map is produced;
- ``pack_spots`` → ``unpack_spots`` → the host's spot lists as the dense
  path's and JAX's;
- an sp 2 run in process is the same with the flag on and off (the sp path
  does not read it, as JAX's does not).

On identical tag and score maps with many ties at the k-th score, the
port's ``block_spot_candidates`` / ``merge_spot_candidates`` give JAX's
live slots bit for bit, and the dense ``compact_spots`` gives JAX's
``compact_spots(..., "exact")`` bit for bit, empty slots included.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax
import jax.numpy as jnp

from peneo_tpu.config import LiltConfig, PEneoConfig
from peneo_tpu.models import decoder as jd
from peneo_tpu.pipeline.decode import spots_from_device_outputs as \
    jax_host_spots
from peneo_tpu.pipeline.decode import unpack_spots as jax_unpack_spots
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models import decoder as pd
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES
from peneo_tpu_torch.parallel import seq_parallel as sq
from peneo_tpu_torch.pipeline.decode import spots_from_device_outputs, \
    unpack_spots

torch.set_num_threads(1)
H = 96
D_IN = H + H // 4   # LiLT's decoder input: text + layout streams
B = 2
SCORE_TOL = 1e-5
LOSS_TOL = 1e-6
CASES = [(129, 64, 64),   # ragged L, overflow
         (96, 512, 64),   # fewer candidates than k
         (256, 48, 64)]   # several blocks, small k


def _cfg(**kw):
    # initializer_range 0.15 (as tests/test_torch_peneo.py's) spreads the
    # logits to O(1): the argmax decisions sit far above fp32 rounding, so
    # the two packages count the same spots
    bb = LiltConfig(vocab_size=64, hidden_size=H, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=2 * H,
                    channel_shrink_ratio=4).to_dict()
    return PEneoConfig(backbone_name="lilt-infoxlm-base", backbone_config=bb,
                       spot_topk="exact", initializer_range=0.15, **kw)


def _x(Ld, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, Ld, D_IN)).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """JAX's decoder init (its param tree does not depend on L)."""
    return jax.device_get(jd.PEneoDecoder(_cfg()).init(
        jax.random.PRNGKey(1), jnp.asarray(_x(8))))


def _jax(params, cfg, x, **kw):
    return jax.device_get(jd.PEneoDecoder(cfg).apply(params, jnp.asarray(x),
                                                     **kw))


def _port(params, cfg):
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    sd = jax_params_to_state_dict({"peneo_decoder": params["params"]},
                                  port_cfg, partial=True)
    dec = pd.PEneoDecoder(port_cfg)
    dec.load_state_dict({k[len("peneo_decoder."):]: v for k, v in sd.items()})
    return dec.eval()


def _run_port(dec, x, **kw):
    with torch.inference_mode():
        return dec(torch.from_numpy(x), **kw)


def _np(out):
    return {n: {k: np.asarray(v) for k, v in out[n].items()}
            for n in HEAD_NAMES}


def _live(head, b):
    """(idx, tag, score) of the live slots of sample b, in slot order."""
    keep = head["spot_score"][b] >= 0
    return tuple(head[k][b][keep] for k in ("spot_idx", "spot_tag",
                                            "spot_score"))


def _assert_same_live(got, want):
    """Live slots bit for bit, in slot order; equal counts and seq_len."""
    for name in HEAD_NAMES:
        for key in ("spot_count", "seq_len"):
            np.testing.assert_array_equal(got[name][key], want[name][key],
                                          err_msg=(name, key))
        for b in range(B):
            for g, w in zip(_live(got[name], b), _live(want[name], b)):
                np.testing.assert_array_equal(g, w, err_msg=(name, b))


def _assert_matches_jax(got, want, k):
    """Against JAX's spots: equal counts; the live (idx, tag) sets equal
    and their scores within SCORE_TOL, or, where the counts overflow k,
    the sorted live scores within SCORE_TOL."""
    n_live = 0
    for name in HEAD_NAMES:
        np.testing.assert_array_equal(got[name]["spot_count"],
                                      want[name]["spot_count"], err_msg=name)
        for b in range(B):
            gi, gt, gs = _live(got[name], b)
            wi, wt, ws = _live(want[name], b)
            n_live += len(gi)
            if want[name]["spot_count"][b] > k:
                assert len(gs) == len(ws) == k, name
                np.testing.assert_allclose(np.sort(gs), np.sort(ws), rtol=0,
                                           atol=SCORE_TOL, err_msg=name)
                continue
            g = dict(zip(gi.tolist(), zip(gt.tolist(), gs.tolist())))
            w = dict(zip(wi.tolist(), zip(wt.tolist(), ws.tolist())))
            assert g.keys() == w.keys(), (name, b)
            for i in g:
                assert g[i][0] == w[i][0], (name, b, i)
                assert abs(g[i][1] - w[i][1]) <= SCORE_TOL, (name, b, i)
    assert n_live > 100  # the random heads do tag pairs


class _Shapes(TorchDispatchMode):
    """Records the shape and dtype of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen += [(tuple(t.shape), t.dtype) for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)]
        return out


def _grid_maps(seen, Ld, bs):
    """The (…, L, L) int32 / fp32 tensors among ``seen``, L the grid's
    valid or padded length; not the (B, Ld, width) activations of the
    shrink MLP and the combine, whose width may equal Ld (96)."""
    Lp = -(-Ld // bs) * bs
    return [(s, d) for s, d in seen if len(s) >= 3
            and s[-2:] in ((Ld, Ld), (Lp, Lp))
            and s[-1] not in (D_IN, H, H // 2)
            and d in (torch.int32, torch.float32)]


@pytest.mark.parametrize("Ld,k,bs", CASES)
def test_inference_streams_the_dense_spots_and_jaxs(params, Ld, k, bs):
    x = _x(Ld)
    out = {}
    for stream in (False, True):
        cfg = _cfg(max_spots_per_head=k, spot_streaming=stream,
                   pair_block_size=bs)
        dec = _port(params, cfg)
        shapes = _Shapes()
        with shapes:
            out[stream] = _np(_run_port(dec, x))
        maps = _grid_maps(shapes.seen, Ld, bs)
        assert (not maps) if stream else maps, maps[:3]
    _assert_same_live(out[True], out[False])
    want = _jax(params, _cfg(max_spots_per_head=k, spot_streaming=True,
                             pair_block_size=bs), x)
    _assert_matches_jax(out[True], want, k)
    for name in HEAD_NAMES:  # JAX's slot count: k
        assert out[True][name]["spot_idx"].shape == (B, k)


def _labels(Ld, seed=7):
    """tests/test_spot_streaming.py's sparse dense int8 labels."""
    rng = np.random.default_rng(seed)
    labels = {}
    for name in HEAD_NAMES:
        m = np.zeros((B, Ld, Ld), np.int8)
        for b in range(B):
            ij = rng.integers(0, Ld, (20, 2))
            ij.sort(axis=1)
            m[b, ij[:, 0], ij[:, 1]] = rng.integers(1, 2, 20)
        labels[name] = m
    return labels


def test_eval_also_decode_keeps_the_losses_and_spots(params):
    Ld, k, bs = 129, 64, 64
    x, labels = _x(Ld, seed=3), _labels(Ld)
    port_labels = {n: torch.from_numpy(m) for n, m in labels.items()}
    res = {}
    for stream in (False, True):
        dec = _port(params, _cfg(max_spots_per_head=k, spot_streaming=stream,
                                 pair_block_size=bs))
        shapes = _Shapes()
        with shapes:
            losses, spots = _run_port(dec, x, labels=port_labels,
                                      also_decode=True)
        maps = _grid_maps(shapes.seen, Ld, bs)
        assert (not maps) if stream else maps, maps[:3]
        res[stream] = ({n: float(v) for n, v in losses.items()}, _np(spots))
    want_losses, want_spots = _jax(
        params, _cfg(max_spots_per_head=k, spot_streaming=True,
                     pair_block_size=bs), x,
        labels={n: jnp.asarray(m) for n, m in labels.items()},
        also_decode=True)
    for key, v in res[True][0].items():
        assert abs(v - res[False][0][key]) <= LOSS_TOL * abs(v), key
        np.testing.assert_allclose(v, float(want_losses[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    _assert_same_live(res[True][1], res[False][1])
    _assert_matches_jax(res[True][1], want_spots, k)


def test_streamed_spots_decode_through_the_host_path(params):
    """pack → unpack → the host's row-major spot lists: the dense path's,
    bit for bit, and JAX's (scores within SCORE_TOL)."""
    Ld, k, bs = 96, 512, 64
    x = _x(Ld, seed=5)
    host = {}
    for stream in (False, True):
        dec = _port(params, _cfg(max_spots_per_head=k, spot_streaming=stream,
                                 pair_block_size=bs))
        big, small = (t.numpy() for t in pd.pack_spots(_run_port(dec, x)))
        host[stream] = [spots_from_device_outputs(unpack_spots(big, small),
                                                  b, Ld) for b in range(B)]
    assert host[True] == host[False]
    jax_out = jd.PEneoDecoder(_cfg(max_spots_per_head=k, spot_streaming=True,
                                   pair_block_size=bs)).apply(
        params, jnp.asarray(x))
    jbig, jsmall = jax.device_get(jd.pack_spots(jax_out))
    for b in range(B):
        want = jax_host_spots(jax_unpack_spots(jbig, jsmall), b, Ld)
        for name in HEAD_NAMES:
            got = host[True][b][name]
            assert [s[:3] for s in got] == [s[:3] for s in want[name]], name
            np.testing.assert_allclose([s[3] for s in got],
                                       [s[3] for s in want[name]], rtol=0,
                                       atol=SCORE_TOL, err_msg=name)


def test_sp2_in_process_ignores_the_flag(params):
    """Both sp shards in one process, and their merge: the same spots with
    ``spot_streaming`` on and off, bit for bit."""
    Ld, k, bs = 129, 64, 64
    x = torch.from_numpy(_x(Ld, seed=2))
    got = {}
    for stream in (False, True):
        dec = _port(params, _cfg(max_spots_per_head=k, spot_streaming=stream,
                                 pair_block_size=bs))
        shards = []
        for s in range(2):
            dec.set_sequence_parallel(s, 2)
            with torch.inference_mode():
                shards.append(_np(dec(x)))
        with torch.inference_mode():
            a, b = dec.handshaking_kernel(dec.shrink_projection(x))
            packed = torch.stack([dec.sp_partials(a, b, Ld, s, 2)[0].packed()
                                  for s in range(2)])
        merged = _np(sq.merge_spots(packed, B, k, Ld, HEAD_NAMES))
        got[stream] = shards + [merged]
    for on, off in zip(got[True], got[False]):
        for name in HEAD_NAMES:
            for key in off[name]:
                np.testing.assert_array_equal(on[name][key], off[name][key],
                                              err_msg=(name, key))


# ----------------------------------------------------------- ties at k
def _tie_maps(Ld, density, seed=11):
    """(B, Ld, Ld) int32 tags (nonzero with ``density``) and fp32 scores
    from three values only: many spots tie at the k-th score."""
    rng = np.random.default_rng(seed)
    tags = np.where(rng.random((B, Ld, Ld)) < density,
                    rng.integers(1, 3, (B, Ld, Ld)), 0).astype(np.int32)
    scores = rng.choice(np.float32([0.5, 0.625, 0.75]),
                        (B, Ld, Ld)).astype(np.float32)
    return tags, scores


def _padded(a, Lp):
    return np.pad(a, [(0, 0), (0, Lp - a.shape[1]), (0, Lp - a.shape[2])])


def _decode_sorted(keys):
    """A block's candidate keys → (idx, tag, score), score descending then
    the lower flat index (JAX's block order)."""
    idx, tag, score = sq.decode_keys(torch.sort(keys, -1,
                                                descending=True).values)
    return {"idx": idx.numpy(), "tag": tag.numpy(), "score": score.numpy()}


@pytest.mark.parametrize("Ld,k,bs,density", [
    (129, 64, 64, 0.6),    # counts overflow k: ties decide the cut
    (96, 512, 64, 0.6),    # more slots than a block's cells
    (40, 256, 16, 0.05)],  # fewer spots than k: empty slots
    ids=["overflow", "wide_k", "empties"])
def test_block_and_merge_match_jax_through_ties(Ld, k, bs, density):
    tags, scores = _tie_maps(Ld, density)
    Lp = -(-Ld // bs) * bs
    tp, sp_ = _padded(tags, Lp), _padded(scores, Lp)
    ours, theirs, count, jcount = [], [], 0, 0
    for r0 in range(0, Lp, bs):
        t, s = tp[:, r0:r0 + bs, r0:], sp_[:, r0:r0 + bs, r0:]
        keys, n = pd.block_spot_candidates(torch.from_numpy(t),
                                           torch.from_numpy(s), r0, r0, Ld, k)
        cand, jn = jax.device_get(jd.block_spot_candidates(
            jnp.asarray(t), jnp.asarray(s), r0, r0, Ld, k, "exact"))
        np.testing.assert_array_equal(n.numpy(), jn)
        got = _decode_sorted(keys)
        for b in range(B):
            live = cand["score"][b] >= 0
            assert (got["score"][b] >= 0).sum() == live.sum()
            for key in ("idx", "tag", "score"):
                np.testing.assert_array_equal(
                    got[key][b][:live.sum()], cand[key][b][live],
                    err_msg=(r0, key))
        ours.append(keys)
        theirs.append(cand)
        count, jcount = count + n, jcount + jn
    merged = _np({n: pd.merge_spot_candidates(ours, count, k, Ld)
                  for n in HEAD_NAMES})
    jmerged = jax.device_get(jd.merge_spot_candidates(
        [{key: jnp.asarray(v) for key, v in c.items()} for c in theirs],
        jnp.asarray(jcount), k, Ld))
    want = {n: jmerged for n in HEAD_NAMES}
    _assert_same_live(merged, want)
    # the dense path: JAX's compact_spots, every slot
    dense = {key: v.numpy() for key, v in pd.compact_spots(
        torch.from_numpy(tags), torch.from_numpy(scores), k).items()}
    jdense = jax.device_get(jd.compact_spots(jnp.asarray(tags),
                                             jnp.asarray(scores), k, "exact"))
    for key in jdense:
        np.testing.assert_array_equal(dense[key], np.asarray(jdense[key]),
                                      err_msg=key)
    # the streamed merge is the dense top k on its live slots
    _assert_same_live(merged, {n: dense for n in HEAD_NAMES})
    overflow = (dense["spot_count"] > min(k, Ld * Ld)).any()
    assert overflow == (density > 0.5)
