"""Training BiACM attention of the PyTorch port
(peneo_tpu_torch/ops/biacm_attention.py): the plain twin and
``BiacmAttentionTrain`` on CPU tensors against the JAX package's Pallas
training kernels (``biacm_attention_train(..., interpret=True,
inkernel_rng=False)``) fed the same mask bits — forward values and all six
gradients, at tests/test_biacm_train.py's tolerances (fp32: 2e-5 forward,
2e-4 gradients) — and the dropout bits the CUDA mask kernel draws on the
card (Philox4x32-10, one draw per two adjacent keys): known-answer
vectors, the mapping of a draw's words to keys and streams, tile
independence, the kept share, distinct streams, determinism per seed; the
bit-packed keep flags the forward hands to the backward (``pack`` /
``unpack``, the twin's gradients from them); and the one-draw-per-element
bits the rel-bias kernels keep."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from peneo_tpu.ops.biacm_attention import biacm_attention_train as jax_train
from peneo_tpu_torch.ops import biacm_attention as ba

torch.set_num_threads(1)
B, NH, DT, DL = 2, 2, 64, 16
SCALES = (1.0 / DT ** 0.5, 1.0 / DL ** 0.5)
NEG = np.finfo(np.float32).min / 2


def _inputs(L, seed):
    rng = np.random.default_rng(seed)
    qkv = [(rng.standard_normal((B, NH, L, d)) * 0.5).astype(np.float32)
           for d in (DT, DT, DT, DL, DL, DL)]
    bias = np.zeros((B, L), np.float32)
    bias[0, L - 7:] = NEG
    bias[1, :5] = NEG
    dct = rng.standard_normal((B, NH, L, DT)).astype(np.float32)
    dcl = rng.standard_normal((B, NH, L, DL)).astype(np.float32)
    bits = [rng.integers(0, 2 ** 32, size=(B, NH, L, L), dtype=np.uint64)
            .astype(np.uint32) for _ in range(2)]
    return qkv, bias, (dct, dcl), bits


def _jax(qkv, bias, dctx, bits, rate):
    import jax

    def f(*xs):
        ct, cl = jax_train(*xs, jnp.asarray(bias),
                           (jnp.asarray(bits[0]), jnp.asarray(bits[1])),
                           *SCALES, rate=rate, interpret=True,
                           inkernel_rng=False)
        return ct, cl

    args = [jnp.asarray(x) for x in qkv]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(tuple(jnp.asarray(d) for d in dctx))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def _port(fn, qkv, bias, dctx, bits, rate):
    leaves = [torch.from_numpy(x).requires_grad_() for x in qkv]
    tbits = tuple(torch.from_numpy(b.view(np.int32)) for b in bits)
    out = fn(*leaves, torch.from_numpy(bias), tbits, *SCALES, rate)
    grads = torch.autograd.grad(out, leaves,
                                tuple(torch.from_numpy(d) for d in dctx))
    return ([o.detach().numpy() for o in out],
            [g.numpy() for g in grads])


@pytest.mark.parametrize("fn", ["twin", "function"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [128, 40])
def test_matches_pallas_training_kernel(L, rate, fn):
    qkv, bias, dctx, bits = _inputs(L, seed=L + int(rate * 10))
    want_out, want_grads = _jax(qkv, bias, dctx, bits, rate)
    impl = (ba.biacm_attention_train_reference if fn == "twin"
            else ba.biacm_attention_train)
    got_out, got_grads = _port(impl, qkv, bias, dctx, bits, rate)
    for got, want, name in zip(got_out, want_out, ("ctx_t", "ctx_l")):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                                   err_msg=name)
    for got, want, name in zip(got_grads, want_grads,
                               ("qt", "kt", "vt", "ql", "kl", "vl")):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_seed_path_matches_explicit_bits():
    """An int seed on CPU tensors draws attention_dropout_bits of it."""
    qkv, bias, dctx, _ = _inputs(48, seed=3)
    bits = ba.attention_dropout_bits(99, B, NH, 48)
    t = [torch.from_numpy(x) for x in qkv]
    a = ba.biacm_attention_train(*t, torch.from_numpy(bias), 99, *SCALES, 0.1)
    b = ba.biacm_attention_train_reference(*t, torch.from_numpy(bias), bits,
                                           *SCALES, 0.1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_philox_known_answers():
    """Random123's philox4x32-10 known-answer vectors."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = ba.philox4x32_10(*(torch.tensor(c) for c in ctr), *key)
        assert [int(g) for g in got] == list(want)


def test_bits_are_tile_independent():
    """A slice of the full draw equals the draw of the slice's indices: the
    bits are a pure function of (seed, b, h, i, j, stream)."""
    seed, L = 2 ** 40 + 17, 96
    full = ba.attention_dropout_bits(seed, 3, 2, L)
    b = torch.tensor([2]).view(-1, 1, 1, 1)
    h = torch.tensor([1]).view(1, -1, 1, 1)
    i = torch.arange(33, 70).view(1, 1, -1, 1)
    j = torch.arange(64, 96).view(1, 1, 1, -1)
    part = ba.dropout_bits_at(seed, b, h, i, j)
    for s in range(2):
        assert torch.equal(part[s][0, 0], full[s][2, 1, 33:70, 64:96])


def test_kept_share_streams_and_determinism():
    rate, L = 0.1, 128
    b1, b2 = ba.attention_dropout_bits(7, 4, 4, L)
    thr = ba.keep_threshold(rate)
    k1, k2 = b1 < thr, b2 < thr
    n = k1.numel()
    # binomial: 4 standard deviations of the share over n draws
    tol = 4 * (rate * (1 - rate) / n) ** 0.5
    for k in (k1, k2):
        assert abs(k.float().mean().item() - (1 - rate)) < tol
    # independent streams differ on ~2·r·(1-r) of the elements
    differ = (k1 != k2).float().mean().item()
    assert abs(differ - 2 * rate * (1 - rate)) < 4 * (0.18 * 0.82 / n) ** 0.5
    again = ba.attention_dropout_bits(7, 4, 4, L)
    assert torch.equal(again[0], b1) and torch.equal(again[1], b2)
    other = ba.attention_dropout_bits(8, 4, 4, L)
    assert not torch.equal(other[0], b1)
    assert int(b1.min()) >= 0 and int(b1.max()) < 2 ** 32


@pytest.mark.parametrize("L", [6, 7])
def test_two_keys_per_draw(L):
    """Bits at keys (2m, 2m + 1) of query i are words 0-1 / 2-3 (text,
    layout) of the one draw at counter (m, i, h, b); an odd L uses half of
    its last draw."""
    seed = 2 ** 33 + 5
    b1, b2 = ba.attention_dropout_bits(seed, 2, 3, L)
    assert b1.shape == b2.shape == (2, 3, L, L)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for b, h, i, m in [(0, 0, 0, 0), (1, 2, L - 1, (L - 1) // 2), (1, 1, 3, 1)]:
        w = [int(x) for x in ba.philox4x32_10(
            *(torch.tensor(c) for c in (m, i, h, b)), *key)]
        assert [int(b1[b, h, i, 2 * m]), int(b2[b, h, i, 2 * m])] == w[:2]
        if 2 * m + 1 < L:
            assert [int(b1[b, h, i, 2 * m + 1]),
                    int(b2[b, h, i, 2 * m + 1])] == w[2:]
    assert not torch.equal(b1, b2)
    assert not torch.equal(b1[..., 0::2][..., : L // 2], b1[..., 1::2])


def test_kept_share_at_the_card_gate():
    """The kept share of each stream within 2e-3 of 1 - rate (the gate the
    kernels' masks are held to on the card), over 1.6 M draws."""
    b1, b2 = ba.attention_dropout_bits(0, 2, 3, 513)
    thr = ba.keep_threshold(0.1)
    for bits in (b1, b2):
        assert abs((bits < thr).float().mean().item() - 0.9) < 2e-3


@pytest.mark.parametrize("L", [1, 31, 32, 33, 200, 512])
def test_pack_unpack_keep_mask(L):
    """pack → unpack is the identity; key j sits at bit j % 32 of word
    j // 32, the bits past L are 0."""
    rng = np.random.default_rng(L)
    keep = torch.from_numpy(rng.random((2, 3, 4, L)) < 0.9)
    words = ba.pack_keep_mask(keep)
    assert words.dtype == torch.int32
    assert words.shape == (2, 3, 4, (L + 31) // 32)
    assert torch.equal(ba.unpack_keep_mask(words, L), keep)
    j = L - 1
    got = (int(words[1, 2, 3, j // 32]) >> (j % 32)) & 1
    assert got == int(keep[1, 2, 3, j])
    u = words.to(torch.int64) & 0xFFFFFFFF
    assert int(u[..., -1].max()) < 2 ** ((L - 1) % 32 + 1)
    ones = ba.pack_keep_mask(torch.ones(L, dtype=torch.bool))
    full = [0xFFFFFFFF] * (L // 32) + ([2 ** (L % 32) - 1] if L % 32 else [])
    assert (ones.to(torch.int64) & 0xFFFFFFFF).tolist() == full


def test_twin_gradients_from_packed_mask():
    """The twin fed keep_mask_bits of the packed keep flags gives the
    outputs and gradients it gives from the bits themselves."""
    L, rate = 40, 0.1
    qkv, bias, dctx, bits = _inputs(L, seed=11)
    want_out, want_grads = _port(ba.biacm_attention_train_reference, qkv,
                                 bias, dctx, bits, rate)
    thr = ba.keep_threshold(rate)
    keep = torch.stack([torch.from_numpy(b.astype(np.int64)) < thr
                        for b in bits])
    packed = ba.pack_keep_mask(keep)
    assert packed.shape == (2, B, NH, L, 2)
    again = ba.keep_mask_bits(packed, L)
    leaves = [torch.from_numpy(x).requires_grad_() for x in qkv]
    out = ba.biacm_attention_train_reference(
        *leaves, torch.from_numpy(bias), again, *SCALES, rate)
    grads = torch.autograd.grad(out, leaves,
                                tuple(torch.from_numpy(d) for d in dctx))
    for got, want in zip(list(out) + list(grads), want_out + want_grads):
        assert np.array_equal(got.detach().numpy(), want)


@pytest.mark.parametrize("L", [7, 8])
def test_four_keys_per_draw(L):
    """The rel-bias mask's bits at keys 4m .. 4m + 3 of query i are words
    0-3 of the one draw at counter (m, i, h, b); L = 7 uses three words of
    its last draw. A slice of the full draw equals the draw of the slice's
    indices (tile independence)."""
    seed = 2 ** 40 + 17
    bits = ba.element_dropout_bits(seed, 2, 3, L)
    assert bits.shape == (2, 3, L, L)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for b, h, i, m in [(0, 0, 0, 0), (1, 2, L - 1, (L - 1) // 4),
                       (1, 1, 3, 1), (0, 2, 5, 0)]:
        w = [int(x) for x in ba.philox4x32_10(
            *(torch.tensor(c) for c in (m, i, h, b)), *key)]
        n = min(4, L - 4 * m)
        assert bits[b, h, i, 4 * m:4 * m + n].tolist() == w[:n]
    # the draw of query i differs from that of query i + 1 and of head h + 1
    assert not torch.equal(bits[0, 0, 0], bits[0, 0, 1])
    assert not torch.equal(bits[0, 0], bits[0, 1])
    big = ba.element_dropout_bits(seed, 2, 3, 4 * L + 1)
    assert torch.equal(big[..., :L, :L], bits)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32


def test_cuda_launchers_refuse_cpu_tensors():
    qkv, bias, _, _ = _inputs(16, seed=2)
    t = [torch.from_numpy(x) for x in qkv]
    with pytest.raises(ValueError, match="CUDA"):
        ba.biacm_attention_train_fwd_cuda(*t, torch.from_numpy(bias), 1,
                                          *SCALES, 0.1)
    assert ba.biacm_attention_train_fwd_cuda.launches == 0
    assert ba.biacm_attention_train_bwd_cuda.launches == 0
