"""The output check fails what it has to fail. A tiny serving cell runs on
the CPU with the timed path broken underneath, and ``correct`` comes out
false: half of each batch served from the other half's inputs, a spot
altered where the forward produces it, a record altered where the decode
produces it; the control and the program's own lower precisions read above
the limits that the program as configured (float32 at this size) reads
below; and a check that finds nothing to compare, because the program no
longer passes where the benchmark looks, fails rather than passes.

A serving cell on one card holds no state that a step could leave unchanged
and makes no exchange between cards, so those faults do not apply."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import CELL, tiny_root

SEED = 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # float32 on the CPU: the sound program reads rounding (~1e-7), so the
    # tiny model's small spread between cells still tells a fault
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def run(root, **kw):
    out = run_cell(CELL, SEED, 0.3, False, device="cpu", root=root, **kw)
    return out["checks"]


def correct(checks):
    return all(c["ok"] for c in checks.values())


def test_the_program_as_configured_is_correct(root):
    checks = run(root)
    assert correct(checks), checks


def test_the_control_is_not_correct(root):
    sound = run(root)["spot_error_rms"]["value"]
    control = run(root, precision="int8")
    assert not correct(control)
    assert control["spot_error_rms"]["value"] > 10 * sound


def test_half_of_each_batch_left_out(root, monkeypatch):
    from peneo_tpu_torch.pipeline.infer import InferenceService

    forward = InferenceService._forward

    def half(self, ids, bbox, mask, image):
        h = ids.shape[0] // 2
        ids, bbox, mask = (torch.cat([t[:h], t[:h], t[:h]])[:t.shape[0]]
                           for t in (ids, bbox, mask))
        return forward(self, ids, bbox, mask, image)

    monkeypatch.setattr(InferenceService, "_forward", half)
    checks = run(root)
    assert not checks["spot_error_rms"]["ok"], checks


def test_a_spot_altered_where_it_is_produced(root, monkeypatch):
    from peneo_tpu_torch.pipeline.infer import InferenceService

    forward = InferenceService._forward

    def altered(self, *args):
        big, small = forward(self, *args)
        big = big.clone()
        big[:, 0, :, 0] += 1  # every head's first spot moves one cell on
        return big, small

    monkeypatch.setattr(InferenceService, "_forward", altered)
    checks = run(root)
    assert not checks["spot_error_rms"]["ok"], checks


def test_a_record_altered_where_it_is_produced(root, monkeypatch):
    from peneo_tpu_torch.pipeline import decode

    original = decode.decode_page_record

    def altered(*args, **kwargs):
        rec = original(*args, **kwargs)
        rec["lines"] = rec["lines"][1:]
        return rec

    monkeypatch.setattr(decode, "decode_page_record", altered)
    checks = run(root)
    assert not checks["record_mismatches"]["ok"], checks


@pytest.mark.parametrize("precision", ["int8", "int8_pair_head", "fp8"])
def test_a_lower_precision_fails_the_pair_stage(root, precision):
    sound = run(root)["pair_head_rel_error"]["value"]
    checks = run(root, precision=precision)
    assert not correct(checks)
    assert checks["pair_head_rel_error"]["value"] > 10 * sound, checks


def test_decodes_the_check_cannot_see_fail(root, monkeypatch):
    # the serving loop reaches the decode by another name: the benchmark's
    # log of served spots stays empty
    from peneo_tpu_torch.pipeline import decode, infer

    monkeypatch.setattr(infer, "dec", types.SimpleNamespace(
        **{k: getattr(decode, k) for k in dir(decode)
           if not k.startswith("__")}))
    checks = run(root)
    assert checks["pages_compared"]["value"] == 0, checks
    assert not correct(checks)


def test_a_pair_stage_the_check_cannot_see_fails(root, monkeypatch):
    # the decoder calls its combine without the module's hooks
    from peneo_tpu_torch.models.decoder import HandshakingKernel

    monkeypatch.setattr(HandshakingKernel, "__call__",
                        HandshakingKernel.forward)
    checks = run(root)
    assert checks["pair_rows_compared"]["value"] == 0, checks
    assert not checks["pair_head_rel_error"]["ok"], checks
    assert not correct(checks)
