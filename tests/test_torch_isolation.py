"""The PyTorch port stands alone: nothing in peneo_tpu_torch/ or
chip_smoke.py imports jax, flax or peneo_tpu (nor msgpack or safetensors:
the port reads those files itself), and the package, its models, its
serving pipeline, its checkpoint readers, its training pipeline, its
data-, tensor- and sequence-parallel modules, the serving artifact, the
profiling utilities and the benches import with those modules blocked."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "peneo_tpu", "msgpack", "safetensors")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "peneo_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def _forbidden(name):
    return any(name == m or name.startswith(m + ".") for m in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_flax_or_peneo_tpu_import(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_imports_with_jax_flax_and_peneo_tpu_blocked():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import peneo_tpu_torch, peneo_tpu_torch.models.peneo\n"
        "import peneo_tpu_torch.pipeline.infer, peneo_tpu_torch.serve\n"
        "import peneo_tpu_torch.models.convert\n"
        "import peneo_tpu_torch.run_rfund, peneo_tpu_torch.run_sibr\n"
        "import peneo_tpu_torch.pipeline.trainer, peneo_tpu_torch.pipeline.train\n"
        "import peneo_tpu_torch.pipeline.checkpoint\n"
        "import peneo_tpu_torch.pipeline.evaluation\n"
        "import peneo_tpu_torch.pipeline.loader, peneo_tpu_torch.ops.losses\n"
        "import peneo_tpu_torch.data.datasets, peneo_tpu_torch.data.collator\n"
        "import peneo_tpu_torch.ops.quant, peneo_tpu_torch.utils.visualize\n"
        "import peneo_tpu_torch.pipeline.weights_io\n"
        "import peneo_tpu_torch.generate_peneo_weights\n"
        "import peneo_tpu_torch.parallel.dist\n"
        "import peneo_tpu_torch.parallel.seq_parallel\n"
        "import peneo_tpu_torch.parallel.tensor_parallel\n"
        "import peneo_tpu_torch.export_artifact\n"
        "import peneo_tpu_torch.inference_artifact\n"
        "import peneo_tpu_torch.check_run_artifact\n"
        "import peneo_tpu_torch.utils.profiling\n"
        "import peneo_tpu_torch.utils.tracing\n"
        "import peneo_tpu_torch.bench_serving, peneo_tpu_torch.bench_eval\n"
        "import peneo_tpu_torch.bench, peneo_tpu_torch.bench_sp_pair\n"
        "peneo_tpu_torch.run_rfund.setup\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
