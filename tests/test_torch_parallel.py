"""Training across devices in the port, held to the reference's multi-device
runs on the CPU: ``pipeline_apply`` against the reference's on 4 host
devices (forward within 1e-5, gradients within 1e-4, the reference's own
bounds), ``dp_int8_allreduce`` over a 4-process gloo group against the
reference's 4-device ``shard_map`` run (within 1e-6, every row within
max|g|/127) and on one rank (the identity round), and the activation
hooks (with rules on a one-device mesh the dense smoke config's logits
stay bit for bit).  The reference runs in one subprocess; the gloo ranks
are processes of their own."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.pipeline_parallel import pipeline_apply, split_stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

L, D, B, N_MICRO = 8, 16, 12, 3


def _pipe_inputs():
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((L, D, D)) * D ** -0.5
                  ).astype(np.float32),
            "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32),
            "g": rng.standard_normal((4, 256)).astype(np.float32)}


_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "src")
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.runtime.grad_compress import dp_int8_allreduce
from repro.runtime.pipeline_parallel import pipeline_apply, split_stages
from repro.sharding.api import shard_map_compat

inp = np.load(sys.argv[1])
params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
x = jnp.asarray(inp["x"])

def layer_fn(lp, x):
    return jnp.tanh(x @ lp["w"] + lp["b"])

mesh = make_mesh((4,), ("pipe",))
sp = split_stages(params, 4)

def loss(sp):
    return jnp.sum(pipeline_apply(layer_fn, sp, x, n_micro=3, mesh=mesh) ** 2)

y = pipeline_apply(layer_fn, sp, x, n_micro=3, mesh=mesh)
g = jax.grad(loss)(sp)
dmesh = make_mesh((4,), ("data",))

def f(gr):
    return dp_int8_allreduce({"w": gr}, "data")["w"]

red = jax.jit(shard_map_compat(f, dmesh, (P("data"),), P("data")))(
    jnp.asarray(inp["g"]))
np.savez(sys.argv[2], y=np.asarray(y), gw=np.asarray(g["w"]),
         gb=np.asarray(g["b"]), red=np.asarray(red))
print("ok")
"""

_GLOO = r"""
import sys
sys.path.insert(0, "src")
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, world, port, path, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.runtime.grad_compress import dp_int8_allreduce
    dm = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    g = torch.from_numpy(np.load(path)["g"][rank:rank + 1])
    r = dp_int8_allreduce({"w": g}, "data", dm)["w"]
    np.save(f"{out}_{rank}.npy", r.numpy())
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(rank_main, args=(4, port, sys.argv[1], sys.argv[2]), nprocs=4)
    print("ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's pipeline and int8 all-reduce on 4 host devices, and
    the port's int8 all-reduce on 4 gloo ranks, over the same numpy
    inputs (the two subprocesses run side by side)."""
    d = tmp_path_factory.mktemp("parallel")
    inp = _pipe_inputs()
    np.savez(d / "in.npz", **inp)
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", _REF, str(d / "in.npz"),
                            str(d / "ref.npz")], cwd=REPO, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    gloo_py = d / "gloo_ranks.py"
    gloo_py.write_text(_GLOO)
    gl = subprocess.run([sys.executable, str(gloo_py), str(d / "in.npz"),
                         str(d / "port")], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=300)
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-2000:]
    assert gl.returncode == 0, gl.stderr[-2000:]
    got = np.concatenate([np.load(d / f"port_{r}.npy") for r in range(4)])
    return inp, dict(np.load(d / "ref.npz")), got


def _layer(lp, x):
    return torch.tanh(x @ lp["w"] + lp["b"])


def test_pipeline_matches_reference_forward_and_grads(runs):
    inp, ref, _ = runs
    params = {k: torch.from_numpy(inp[k]) for k in ("w", "b")}
    mesh = make_mesh((4,), ("pipe",), ["cpu"] * 4)
    sp = {k: v.detach().clone().requires_grad_()
          for k, v in split_stages(params, 4).items()}
    y = pipeline_apply(_layer, sp, torch.from_numpy(inp["x"]), N_MICRO, mesh)
    (y ** 2).sum().backward()
    assert np.abs(y.detach().numpy() - ref["y"]).max() < 1e-5
    assert np.abs(sp["w"].grad.numpy() - ref["gw"]).max() < 1e-4
    assert np.abs(sp["b"].grad.numpy() - ref["gb"]).max() < 1e-4
    # and the plain stacked apply over the same microbatches, bit for bit
    with torch.no_grad():
        xs = torch.from_numpy(inp["x"]).reshape(N_MICRO, -1, D)
        plain = []
        for xm in xs:
            for i in range(L):
                xm = _layer({k: v[i] for k, v in params.items()}, xm)
            plain.append(xm)
    assert torch.equal(y.detach(), torch.cat(plain))


def test_pipeline_refuses_distinct_devices():
    mesh = make_mesh((2,), ("pipe",), ["cpu", "cuda:0"])
    with pytest.raises(NotImplementedError, match="A.3"):
        pipeline_apply(_layer, split_stages(
            {"w": torch.zeros(2, D, D), "b": torch.zeros(2, D)}, 2),
            torch.zeros(4, D), 2, mesh)


def test_dp_int8_allreduce_gloo_matches_reference(runs):
    inp, ref, got = runs
    g = inp["g"]
    assert np.abs(got - ref["red"]).max() <= 1e-6
    bound = np.abs(g).max() / 127.0
    assert np.abs(got - g.mean(0)[None]).max() <= bound + 1e-6


_ONE_RANK = r"""
import sys
sys.path.insert(0, "src")
import json
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.runtime.grad_compress import compress_gradients, dp_int8_allreduce
dist.init_process_group("gloo", init_method="tcp://localhost:" + sys.argv[1],
                        world_size=1, rank=0)
dm = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
rng = np.random.default_rng(1)
g = {"w": torch.from_numpy(rng.standard_normal((5, 1000)).astype(np.float32)),
     "b": torch.from_numpy(rng.standard_normal((7,)).astype(np.float32))}
red = dp_int8_allreduce(g, "data", dm)
one = compress_gradients(g)
print(json.dumps({k: bool(torch.equal(red[k], one[k])) for k in g}))
dist.destroy_process_group()
"""


def test_dp_int8_allreduce_one_rank_is_the_identity_round():
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    out = subprocess.run([sys.executable, "-c", _ONE_RANK, port], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": "src"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"w": True,
                                                              "b": True}


def test_hooks_keep_dense_logits_bit_for_bit():
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.io import make_batch
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.api import use_rules
    from repro_torch.sharding.specs import activation_rules

    cfg = get_smoke_config("llama3-8b")
    api = get_model(cfg)
    p = api.init_params(cfg, 0, "cpu")
    batch = make_batch(cfg, 2, 16, seed=0, device="cpu")
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    with torch.no_grad():
        plain = api.forward(p, cfg, batch)
        with use_rules(activation_rules(cfg, mesh)):
            ruled = api.forward(p, cfg, batch)
    assert torch.equal(plain, ruled)
