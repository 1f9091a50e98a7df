"""The port's checkpoint readers and writer (peneo_tpu_torch/pipeline/
weights_io.py) against flax's msgpack serialization and the safetensors
package, exactly: a tree written by the JAX package's
``save_params_msgpack`` (fp32, bf16, int32 and numpy-scalar leaves, nested
dicts, one leaf chunked), the port's writer read back by flax, and
safetensors files of F32, BF16 and I64 tensors. The module imports neither
msgpack nor safetensors."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.serialization as flax_ser
import jax.numpy as jnp

from peneo_tpu.pipeline.checkpoint import save_params_msgpack
from peneo_tpu_torch.pipeline import weights_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    rng = np.random.default_rng(0)
    return {
        "backbone": {
            "layer_0": {"kernel": rng.standard_normal((6, 5)).astype(
                np.float32), "bias": np.zeros(5, np.float32)},
            "emb": {"embedding": rng.standard_normal((40, 8)).astype(
                np.float32)},
        },
        "bf16": jnp.asarray(rng.standard_normal((3, 7)), jnp.bfloat16),
        "ids": np.arange(-5, 7, dtype=np.int32).reshape(3, 4),
        "step": np.int64(12345),
        "scale": np.float32(0.125),
        "big": rng.standard_normal((9, 11)).astype(np.float32),  # chunked
    }


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:  # the port widens bf16 to fp32
        want = want.astype(np.float32)
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_reads_what_flax_writes(tmp_path, monkeypatch):
    # chunk every leaf over 256 bytes: "big" (396 B) goes in two chunks
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 256)
    tree = _tree()
    path = str(tmp_path / "params.msgpack")
    save_params_msgpack(tree, path)
    with open(path, "rb") as f:
        data = f.read()
    assert b"__msgpack_chunked_array__" in data
    want = flax_ser.msgpack_restore(data)
    got = weights_io.read_flax_msgpack(path)
    _assert_same(got, want)
    assert got["step"].shape == () and got["step"] == 12345
    assert got["bf16"].dtype == np.float32
    # numpy scalars reach to_bytes as such (ext type 3) outside
    # save_params_msgpack, which turns every leaf into an array
    scalars = {"step": np.int64(7), "scale": np.float32(0.5),
               "flag": np.bool_(True)}
    path = str(tmp_path / "scalars.msgpack")
    with open(path, "wb") as f:
        f.write(flax_ser.to_bytes(scalars))
    got = weights_io.read_flax_msgpack(path)
    for k, v in scalars.items():
        assert type(got[k]) is type(v) and got[k] == v, k


def test_flax_reads_what_the_port_writes(tmp_path, monkeypatch):
    monkeypatch.setattr(weights_io, "MAX_CHUNK_SIZE", 256)
    tree = _tree()
    tree["bf16"] = np.asarray(tree["bf16"], np.float32)
    tree["meta"] = {"name": "peneo", "n": -3, "big_n": 2 ** 40, "x": 0.5,
                    "ok": True, "none": None}
    path = str(tmp_path / "out.msgpack")
    weights_io.write_flax_msgpack(tree, path)
    with open(path, "rb") as f:
        data = f.read()
    assert b"__msgpack_chunked_array__" in data
    back = flax_ser.msgpack_restore(data)
    meta = back.pop("meta")
    assert meta == {"name": "peneo", "n": -3, "big_n": 2 ** 40, "x": 0.5,
                    "ok": True, "none": None}
    tree.pop("meta")
    _assert_same(back, tree)
    assert isinstance(back["scale"], np.float32)
    # and the port reads its own file
    own = weights_io.read_flax_msgpack(path)
    assert own.pop("meta")["big_n"] == 2 ** 40
    _assert_same(own, tree)


def test_reads_what_safetensors_writes(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as load_torch
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(1)
    arrays = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "ids": rng.integers(-2 ** 40, 2 ** 40, (3, 2)).astype(np.int64),
              "scalar": np.array(2.5, np.float32)}
    path = str(tmp_path / "model.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    got = weights_io.read_safetensors(path)
    want = load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    bf = {"h": torch.randn(5, 3).to(torch.bfloat16)}
    bf_path = str(tmp_path / "bf16.safetensors")
    save_torch(bf, bf_path)
    got = weights_io.read_safetensors(bf_path)["h"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, load_torch(bf_path)["h"].float()
                                  .numpy())


def test_imports_neither_msgpack_nor_safetensors():
    code = ("import sys\n"
            "for m in ('msgpack', 'safetensors', 'flax', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "import peneo_tpu_torch.pipeline.weights_io\n"
            "import peneo_tpu_torch.generate_peneo_weights\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_truncated_file_raises(tmp_path):
    path = str(tmp_path / "params.msgpack")
    save_params_msgpack(_tree(), path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-10])
    with pytest.raises(ValueError):
        weights_io.read_flax_msgpack(path)
