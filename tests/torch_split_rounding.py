"""A one-off CPU comparison, run by hand (not collected by pytest):

    JAX_PLATFORMS=cpu python tests/torch_split_rounding.py

At ``tests/test_torch_fsdp.py``'s widths (LiLT, hidden 64, its weights and
batch, fp32, dropout 0), 3 steps of the JAX package on one device, on its
dp 2 × tp 2 mesh (with and without fsdp) and its dp 2 × sp 2 mesh, and of
the port in one process. Prints each run's relative distance (‖a − b‖ /
‖b‖ per tensor, in the port's keys) from JAX's one-device run for the
decoder's shrink projection, the four largest distances, and the largest
relative loss and grad-norm differences. It measures how far JAX's own
split sits from its one-device run, to compare with the port's split
(``test_fsdp_equals_the_grid_without_it``: the shrink bias 3.3e-5 off one
process at dp 2 × tp 2, 1.4e-5 at dp 2 × sp 2).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import conftest  # noqa: E402,F401  (8 virtual CPU devices for the meshes)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_fsdp as F  # noqa: E402
from peneo_tpu.models.peneo import PEneoModel  # noqa: E402
from peneo_tpu.parallel import mesh as pmesh  # noqa: E402
from peneo_tpu.pipeline import train as JT  # noqa: E402
from peneo_tpu_torch.config import PEneoConfig as PortConfig  # noqa: E402
from peneo_tpu_torch.models.convert import jax_params_to_state_dict  # noqa
from test_torch_tensor_parallel import _rel  # noqa: E402


def jax_steps(cfg, params, batch, mesh_kw=None, sp=False, fsdp=False):
    """STEPS JAX steps on one device or a mesh → ([(loss, grad norm)],
    the parameters in the port's keys)."""
    opt = JT.make_optimizer(None, lr=F.LR, total_steps=10,
                            downstream_speedup_ratio=F.SPEEDUP)
    mesh = None
    if mesh_kw:
        n = int(np.prod(list(mesh_kw.values())))
        mesh = pmesh.make_mesh(**mesh_kw, devices=jax.devices()[:n])
    model = PEneoModel(cfg, dtype=jax.numpy.float32,
                       mesh=mesh if mesh_kw and mesh_kw.get("tp", 1) > 1
                       else None)
    state = JT.create_train_state(cfg, model, opt, batch, params=params)
    step = JT.jit_train_step(model, opt)
    if mesh is not None:
        state = JT.shard_state(state, mesh, pmesh.param_shardings(
            state.params, mesh, fsdp=fsdp))
        bs = pmesh.batch_sharding(mesh)
        batch = jax.tree_util.tree_map(lambda x: jax.device_put(x, bs),
                                       batch)
        if sp:
            step = JT.make_sp_train_step(model, opt, mesh, sp_block_size=8)
    steps = []
    for _ in range(F.STEPS):
        state, m = step(state, batch)
        steps.append((float(m["total"]), float(m["grad_norm"])))
    sd = jax_params_to_state_dict(jax.device_get(state.params),
                                  PortConfig.from_dict(cfg.to_dict()))
    return steps, {k: v.numpy() for k, v in sd.items()}


def report(name, run, ref):
    dist = {k: _rel(run[1][k], w) for k, w in ref[1].items()}
    shrink = {k: f"{v:.2e}" for k, v in dist.items() if "shrink" in k}
    worst = sorted(dist.items(), key=lambda kv: -kv[1])[:4]
    loss = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(run[0], ref[0]))
    gnorm = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(run[0], ref[0]))
    print(f"{name}: shrink {shrink}; largest "
          f"{[(k, f'{v:.2e}') for k, v in worst]}; loss {loss:.2e}, "
          f"grad norm {gnorm:.2e}")


def main():
    torch.set_num_threads(1)
    cfg, batch = F._cfg("lilt"), F._batch("lilt")
    params = F._jax_params(cfg, batch)
    one = jax_steps(cfg, params, batch)
    report("JAX dp 2 x tp 2", jax_steps(cfg, params, batch, dict(dp=2, tp=2)),
           one)
    report("JAX dp 2 x tp 2 fsdp",
           jax_steps(cfg, params, batch, dict(dp=2, tp=2), fsdp=True), one)
    report("JAX dp 2 x sp 2",
           jax_steps(cfg, params, batch, dict(dp=2, sp=2), sp=True), one)
    port = F._one_process({
        "cfg": cfg.to_dict(),
        "state": jax_params_to_state_dict(params,
                                          PortConfig.from_dict(cfg.to_dict())),
        "batch": F._tensors(batch),
        "opt": {"lr": F.LR, "total_steps": 10,
                "downstream_speedup_ratio": F.SPEEDUP}})
    report("port, one process", (port["steps"], port["params"]), one)


if __name__ == "__main__":
    main()
